"""Training entry point of the port, on the GPU by default.

Usage:
    python -m orion_tpu_torch.train --preset llama-1b-bench [key=value ...]
    python -m orion_tpu_torch.train --preset tiny-llama --device cpu train.num_steps=5

Weights are a seeded random init in ``model.param_dtype`` (``--seed``,
default ``train.seed``) and batches come from ``data.source`` (the
synthetic stream by default). Dotted ``key=value`` arguments override the
preset. Prints a step line every ``train.log_interval`` steps and at the
end ``done: N steps, final loss ..., mean MFU ...``.
"""

from __future__ import annotations

import argparse
import math
import sys


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m orion_tpu_torch.train", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument("--preset", default="tiny-llama")
    parser.add_argument("--list-presets", action="store_true")
    parser.add_argument("--print-config", action="store_true")
    parser.add_argument("--seed", type=int, default=None,
                        help="seed of the random weights (overrides train.seed)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; 'cpu' runs the "
                             "plain PyTorch versions of the kernels)")
    parser.add_argument("overrides", nargs="*",
                        help="dotted config overrides, e.g. train.num_steps=5")
    args = parser.parse_args(argv)

    from orion_tpu_torch.config import get_config, list_presets

    if args.list_presets:
        print("\n".join(list_presets()))
        return 0
    overrides = list(args.overrides)
    if args.seed is not None:
        overrides.append(f"train.seed={args.seed}")
    cfg = get_config(args.preset, overrides)
    if args.print_config:
        print(cfg.to_json())
        return 0

    from orion_tpu_torch.train import Trainer

    history = Trainer(cfg, device=args.device).fit()
    if history:
        last = history[-1]
        mfu = sum(h.mfu for h in history) / len(history)
        mfu_s = "n/a (no peak rate for the CPU)" if math.isnan(mfu) else f"{mfu * 100:.2f}%"
        print(f"done: {last.step} steps, final loss {last.loss:.4f}, mean MFU {mfu_s}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
