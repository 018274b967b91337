#!/usr/bin/env python3
"""Time RMSNorm through the port's entry point, ``orion_tpu_torch.ops.rmsnorm``,
in one or more checkouts of the repo, in turns on one GPU.

    python3 norm_timing.py                                   # this checkout
    python3 norm_timing.py --tree _scratch/parent --tree .   # two, in turns

Each ``--tree`` is a directory holding an ``orion_tpu_torch`` package; all
are imported into this one process (one after another, each keeping its
own modules) and timed round by round in the order given, so two trees
share the card, its clocks and its neighbours. ``F.rms_norm`` is timed
once a round beside them. Rows, bfloat16 rows and scale:

  fwd_timing  the forward at [8192, 4096] (chip_smoke's timing shape)
  fwd_train   the forward at [16384, 2048] (llama-1b-bench's rows)
  fwd_decode  the forward at [32, 4096] (llama3-8b-infer's decode batch)
  bwd_both    the backward at [16384, 2048] with x and the scale both
              requiring grad (what the training step runs)

Per row: ``ms`` (chip_smoke's time_ms), ``device_ms`` (chip_smoke's
graph_ms: calls replayed from a CUDA graph; the forward rows only) and
``host_us`` (chip_smoke's host_us: wall time of 1000 back-to-back calls
with one synchronize, over 1000). One JSON line per round, then a summary
line with the median, min and max over the rounds, then the card's
nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
EPS = 1e-5
FWD = {"fwd_timing": (8192, 4096), "fwd_train": (16384, 2048), "fwd_decode": (32, 4096)}
BWD = (16384, 2048)


def load_rmsnorm(tree):
    """``orion_tpu_torch.ops.rmsnorm`` of ``tree``; earlier trees' modules
    stay alive through the references their functions hold."""
    for name in [m for m in sys.modules if m.split(".")[0] == "orion_tpu_torch"]:
        del sys.modules[name]
    path = os.path.abspath(tree)
    sys.path.insert(0, path)
    try:
        from orion_tpu_torch.ops import rmsnorm
    finally:
        sys.path.remove(path)
    return lambda x, s: rmsnorm(x, s, eps=EPS)


def library(x, s):
    import torch.nn.functional as F

    return F.rms_norm(x, (x.shape[-1],), s, EPS)


def rows(norm, gen):
    """Every row for one RMSNorm function ``norm(x, scale)``."""
    import torch

    from chip_smoke import graph_ms, host_us, time_ms

    def inputs(R, D):
        x = torch.randn(R, D, generator=gen, device="cuda").to(torch.bfloat16)
        s = (1.0 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(torch.bfloat16)
        return x, s

    res = {}
    for name, (R, D) in FWD.items():
        x, s = inputs(R, D)
        fn = lambda: norm(x, s)  # noqa: E731
        res[name] = {"ms": time_ms(fn), "device_ms": graph_ms(fn), "host_us": host_us(fn)}
    x, s = inputs(*BWD)
    g = torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)
    xr, sr = x.requires_grad_(), s.requires_grad_()
    out = norm(xr, sr)
    fn = lambda: torch.autograd.grad(out, [xr, sr], g, retain_graph=True)  # noqa: E731
    res["bwd_both"] = {"ms": time_ms(fn), "host_us": host_us(fn)}
    return res


def summary(rounds):
    """{tree: {row: {metric: {median, min, max}}}} over the rounds."""
    out = {}
    for tree, tree_rows in rounds[0].items():
        out[tree] = {}
        for row, metrics in tree_rows.items():
            out[tree][row] = {}
            for key in metrics:
                vals = [r[tree][row][key] for r in rounds]
                out[tree][row][key] = {"median": statistics.median(vals),
                                       "min": min(vals), "max": max(vals)}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--tree", action="append",
                        help="checkout holding orion_tpu_torch (repeatable; default: this one)")
    parser.add_argument("--rounds", type=int, default=5)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("norm_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from chip_smoke import smi_line

    norms = {tree: load_rmsnorm(tree) for tree in args.tree or [HERE]}
    norms["F.rms_norm"] = library
    gen = torch.Generator(device="cuda")
    rounds = []
    for i in range(args.rounds):
        gen.manual_seed(i)
        rnd = {tree: rows(norm, gen) for tree, norm in norms.items()}
        torch.cuda.empty_cache()
        print(json.dumps({"round": i, **rnd}), flush=True)
        rounds.append(rnd)
    print(json.dumps({"summary": summary(rounds), "rounds": args.rounds}), flush=True)
    print(smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
