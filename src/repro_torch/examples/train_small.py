"""Train a reduced model for a number of steps on the synthetic LM
pipeline, the reference's ``examples/train_small.py`` on the port (the
training side's end-to-end entry point).

  PYTHONPATH=src python -m repro_torch.examples.train_small \\
      --arch zamba2-2.7b --steps 100 [--device cpu]

With no arguments it trains the reduced granite-3.2-8b for 100 steps of
batch 4 at sequence 64 on the card, as the reference's does;
``main(device="cpu")`` does the same on the CPU.
"""
import sys
from typing import Optional, Sequence

from repro_torch.launch import train

DEFAULTS = ("--arch", "granite-3.2-8b", "--steps", "100", "--batch", "4",
            "--seq", "64")


def main(device: Optional[str] = None, argv: Sequence[str] = ()):
    args = list(argv or DEFAULTS)
    if device is not None:
        args += ["--device", device]
    return train.main(args)


if __name__ == "__main__":
    main(argv=sys.argv[1:])
