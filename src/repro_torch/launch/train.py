"""Training launcher: fault-tolerant loop over the synthetic pipeline.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-1b-a400m \\
      --steps 50 --seq-len 64 --batch 8 --ckpt-dir /tmp/ckpt

Trains the smoke configuration of ``--arch`` on ``--device`` (default
``cuda``; ``--device cpu`` runs it on the host) with the reference's
flags, and prints the reference's final JSON record.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.data.pipeline import make_pipeline
from repro_torch.train.trainer import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2.5-3b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--data", default=None, help="optional tokenized .bin")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    data = make_pipeline(cfg, seq_len=args.seq_len, global_batch=args.batch,
                         path=args.data, device=args.device)
    tr = Trainer(cfg, data, ckpt_dir=args.ckpt_dir,
                 ckpt_every=args.ckpt_every, lr=args.lr, device=args.device)
    start = tr.init_or_restore()
    print(f"training {cfg.name} from step {start} -> {args.steps}")
    tr.train(args.steps, on_step=lambda s, m: (
        print(f"step {s:5d} loss {m['loss']:.4f} "
              f"gnorm {m['grad_norm']:.3f} {m['step_s']*1e3:.0f}ms")
        if s % 5 == 0 else None))
    losses = [h["loss"] for h in tr.history]
    print(json.dumps({"arch": cfg.name, "steps": tr.step,
                      "first_loss": losses[0] if losses else None,
                      "last_loss": losses[-1] if losses else None,
                      "straggler_events": len(tr.monitor.events)}))
    return tr


if __name__ == "__main__":
    main()
