"""Training launcher, ported from the reference's ``repro/launch/train.py``
(its local mode): trains the selected architecture's REDUCED variant for
a number of steps on the synthetic pipeline, the end-to-end entry point of
the training side.

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3.2-8b \\
      --steps 200 --batch 8 --seq 128

It runs on the card; ``--device cpu`` runs on the CPU.  ``--dryrun``
prints the dry run's record of the FULL configuration's train_4k step
on the production 16×16 mesh (``launch.dryrun``: the rank's memory,
collectives and roofline, shape arithmetic only) and returns it.
``main`` returns each step's stats as floats.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.configs import get_reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.models.model import Runtime, init_params
from repro_torch.training import (AdamWConfig, DataConfig, SyntheticDataset,
                                  init_train_state, make_train_step,
                                  save_checkpoint)


def frontend_embeds(cfg: ModelConfig, batch: int, device) -> Optional[
        torch.Tensor]:
    """The reference launcher's stand-in patch or frame embeddings,
    N(0, 0.02) from ``RandomState(0)``, in the model dtype; None for a
    text-only model."""
    n = {"vision": cfg.num_patches, "audio": cfg.encoder_seq_len}.get(
        cfg.frontend)
    if n is None:
        return None
    rng = np.random.RandomState(0)
    return torch.from_numpy(rng.randn(batch, n, cfg.d_model) * 0.02).to(
        device=device, dtype=dtype_of(cfg))


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, float]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3.2-8b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--dryrun", action="store_true",
                    help="print the full configuration's train_4k record "
                         "on the 16x16 mesh instead of training")
    args = ap.parse_args(argv)
    if args.dryrun:
        import json

        from repro_torch.launch.dryrun import run_one
        rec = run_one(args.arch, "train_4k", "16x16")
        print(json.dumps(rec))
        return rec

    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch)
    print(f"training reduced {cfg.name}: {cfg.num_layers}L "
          f"d={cfg.d_model} vocab={cfg.vocab_size}")
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         device=dev)
    state = init_train_state(params)
    step_fn = make_train_step(cfg, AdamWConfig(
        lr=args.lr, warmup_steps=20, total_steps=args.steps), Runtime(),
        loss_chunk=64)
    ds = SyntheticDataset(DataConfig(vocab_size=cfg.vocab_size,
                                     seq_len=args.seq,
                                     global_batch=args.batch))
    extra = frontend_embeds(cfg, args.batch, dev)
    stats = []
    t0 = time.time()
    for i in range(args.steps):
        batch = ds.batch(i)
        if extra is not None:
            batch["extra_embeds"] = extra
        state, st = step_fn(state, batch)
        stats.append({k: float(v) for k, v in st.items()})
        if i % args.log_every == 0 or i == args.steps - 1:
            s = stats[-1]
            print(f"step {i:5d} loss={s['loss']:.4f} ce={s['ce']:.4f} "
                  f"gnorm={s['grad_norm']:.3f} lr={s['lr']:.2e} "
                  f"({(time.time() - t0) / (i + 1):.2f}s/step)")
    if args.ckpt:
        save_checkpoint(args.ckpt, state.params, step=args.steps)
        print(f"saved checkpoint to {args.ckpt}")
    return stats


if __name__ == "__main__":
    main()
