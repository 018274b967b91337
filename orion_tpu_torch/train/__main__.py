"""Training entry point of the port, on the GPU by default.

Usage:
    python -m orion_tpu_torch.train --preset llama-1b-bench [key=value ...]
    python -m orion_tpu_torch.train --preset tiny-llama --device cpu train.num_steps=5
    python -m orion_tpu_torch.train --preset tiny-llama --device cpu \
        checkpoint.directory=/tmp/c train.num_steps=6 --max-restarts 2
    torchrun --nproc_per_node=4 -m orion_tpu_torch.train --preset tiny-llama \
        parallel.sp=4 parallel.sequence_method=ring_striped
    torchrun --nproc_per_node=8 -m orion_tpu_torch.train --preset mistral-7b-fsdp
    torchrun --nproc_per_node=2 -m orion_tpu_torch.train --preset tiny-llama \
        --device cpu parallel.dp=2 train.zero1=true

Weights are a seeded random init in ``model.param_dtype`` (``--seed``,
default ``train.seed``), or the newest intact checkpoint in
``checkpoint.directory`` (written by this package or by the JAX
package's ``train.py``: the format is the same), and batches come from
``data.source`` (the synthetic stream by default). Dotted ``key=value``
arguments override the preset. ``--max-restarts N`` runs the fit under a
supervisor that rebuilds the trainer after a failure and resumes from the
newest checkpoint, up to N times. Prints a step line every
``train.log_interval`` steps and at the end ``done: N steps, final loss
..., mean MFU ...``. On a mesh (``parallel.dp`` x ``parallel.fsdp`` x
``parallel.sp`` = N) it runs as one process a device under ``torchrun
--nproc_per_node=N`` (one GPU each, NCCL; ``--device cpu`` joins the ranks
over gloo); rank 0 prints.
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
    parser.add_argument(
        "--max-restarts", type=int, default=None,
        help="supervisor mode: restart-and-resume after failures, up to N "
             "times (resumes from the newest intact checkpoint); default "
             "from train.max_restarts",
    )
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

    max_restarts = (args.max_restarts if args.max_restarts is not None
                    else cfg.train.max_restarts)
    if max_restarts > 0:
        from orion_tpu_torch.runtime.fault import run_with_restarts

        if not cfg.checkpoint.directory or not cfg.checkpoint.restore:
            parser.error(
                "--max-restarts needs checkpoint.directory set (and "
                "checkpoint.restore=true): without it every restart would "
                "silently retrain from step 0"
            )
        # Thread the supervisor context into each attempt's step log:
        # restart count in the metrics extras, the previous attempt's
        # fault reason on the resume log line.
        last_fault = {"reason": None}

        def _on_retry(attempt, exc):
            last_fault["reason"] = f"{type(exc).__name__}: {exc}"

        history = run_with_restarts(
            lambda attempt: Trainer(cfg, device=args.device).fit(
                restart_info=(attempt, last_fault["reason"])),
            max_restarts=max_restarts,
            on_retry=_on_retry,
        )
    else:
        history = Trainer(cfg, device=args.device).fit()
    from orion_tpu_torch.runtime.distributed import process_index

    if history and process_index() == 0:
        last = history[-1]
        mfu = sum(h.mfu for h in history) / len(history)
        mfu_s = "n/a (no peak rate for the CPU)" if math.isnan(mfu) else f"{mfu * 100:.2f}%"
        print(f"done: {last.step} steps, final loss {last.loss:.4f}, mean MFU {mfu_s}")
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
