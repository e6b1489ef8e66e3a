"""``python -m gazenerf_tpu_torch.cli.visualize`` — the demo GIFs for the
TRAIN keys.

The port's counterpart of ``python -m gazenerf_tpu.cli.visualize``
(upstream ``visualize.py``): ``cli/evaluate.py``'s flow, over the train
split's keys by default.
"""

from __future__ import annotations

import argparse

from gazenerf_tpu_torch.cli.common import add_common_args
from gazenerf_tpu_torch.cli.evaluate import add_eval_args, run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Fit TRAIN subjects and render demo GIFs "
                                            "(PyTorch / CUDA)")
    add_common_args(p)
    add_eval_args(p, default_split="train")
    return run(p.parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
