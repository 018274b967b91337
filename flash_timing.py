#!/usr/bin/env python3
"""Time K3 (the flash-attention forward) and its backward K7/K8 through the
port's wrappers in one or more checkouts of the repo, in turns on one GPU:
K3's index path at the serve's and the training path's shapes, K7 and K8
at the training path's, and K3's explicit-positions branch at the gather
prefill body's shapes, beside SDPA.

    python3 flash_timing.py                                   # this checkout
    python3 flash_timing.py --tree _scratch/parent --tree .   # two, in turns
    python3 flash_timing.py --splits 1,4,5,8                  # + split counts

Each ``--tree`` is a directory holding an ``orion_tpu_torch`` package; all
are imported into this one process (one after another, each keeping its
own modules and building its own kernels) and timed round by round in the
order given, so two trees share the card, its clocks and its neighbours.
bfloat16 rows, chip_smoke.py's inputs:

  k3_serve   flash_attention_cuda at the serve's prefill (4 x 2048 ragged,
             32 heads, 8 kv heads, head_dim 128, seg_pad_zero)
  k3_train   flash_attention_cuda with lse at the training shapes
  k7_train   flash_dq_cuda at the training shapes (causal), from the
             tree's own K3 output and lse
  k8_train   flash_dkv_cuda, the same
  k7pos_train, k8pos_train
             flash_dq_pos_cuda and flash_dkv_pos_cuda at the training
             shapes under chip_smoke's striped positions (causal), from the
             tree's own K3-pos output and lse (trees that have them)
  k7pos_sp, k8pos_sp
             the same at sp_rank's ring step (chip_smoke.sp_step_inputs:
             16384 striped queries over the past block, 32/8 heads)
  k3pos      flash_attention_pos_cuda at the gather body's shapes (4 rows
             of 256 over 128 prefix pages of 64), merge included
  sdpa_pos   SDPA with enable_gqa and the bool mask of the same positions
             (once a round)

``--splits`` adds, for the last tree, ``k3pos_splits_<n>``: the positions
branch with the grid's split count forced to n (the tree's
``ops.attention.grid_splits`` replaced for the row). Per row: ``ms``
(chip_smoke's time_ms) and ``device_ms`` (chip_smoke's graph_ms), and for
each tree after the first whether ``k3_serve``'s output and K7's and K8's
are bitwise the first tree's, and K7-pos's and K8-pos's largest absolute
difference from the first tree's (a redesign sums in another order). A
tree listed more than once (``--tree A --tree B --tree B --tree A``) is
timed each time it comes, its later readings keyed ``<tree>#<n>`` in the
round's line. One JSON line per round, then a summary line with the
median, min and max over every reading of each tree (rounds times
listings, ``n``), then the card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def load_ops(tree):
    """``orion_tpu_torch.ops`` of ``tree`` and its ``ops.attention`` module;
    earlier trees' modules stay alive through the references held."""
    for name in [m for m in sys.modules if m.split(".")[0] == "orion_tpu_torch"]:
        del sys.modules[name]
    path = os.path.abspath(tree)
    sys.path.insert(0, path)
    try:
        from orion_tpu_torch import ops
    finally:
        sys.path.remove(path)
    return ops, sys.modules["orion_tpu_torch.ops.attention"]


def timed(fn):
    from chip_smoke import graph_ms, time_ms

    return {"ms": time_ms(fn), "device_ms": graph_ms(fn)}


def rows(ops, att, inputs, splits):
    """Every row for one tree; also the outputs of k3_serve, K7 and K8 (and
    K7-pos and K8-pos) for the bitwise check."""
    serve, train, pos, striped, sp = inputs
    q, k, v, seg = serve
    kw = dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg, seg_pad_zero=True)
    res = {"k3_serve": timed(lambda: ops.flash_attention_cuda(q, k, v, **kw))}
    outs = {"k3_serve": ops.flash_attention_cuda(q, k, v, **kw)}
    tq, tk, tv, tdo = train
    res["k3_train"] = timed(lambda: ops.flash_attention_cuda(tq, tk, tv, causal=True,
                                                             return_lse=True))
    tout, tlse = ops.flash_attention_cuda(tq, tk, tv, causal=True, return_lse=True)
    delta = (tdo.float() * tout.float()).sum(-1).transpose(1, 2).contiguous()
    bwd = (tq, tk, tv, tdo, tlse, delta)
    res["k7_train"] = timed(lambda: ops.flash_dq_cuda(*bwd, causal=True))
    res["k8_train"] = timed(lambda: ops.flash_dkv_cuda(*bwd, causal=True))
    outs["k7_train"] = ops.flash_dq_cuda(*bwd, causal=True)
    outs["k8_train"] = ops.flash_dkv_cuda(*bwd, causal=True)[0]
    if hasattr(ops, "flash_dq_pos_cuda"):
        sq, sk, sv, skw = striped
        qpos, kpos = skw["q_positions"], skw["kv_positions"]
        sout, slse = ops.flash_attention_pos_cuda(sq, sk, sv, qpos, kpos, return_lse=True)
        sdelta = (tdo.float() * sout.float()).sum(-1).transpose(1, 2).contiguous()
        pbwd = (sq, sk, sv, tdo, slse, sdelta, qpos, kpos)
        res["k7pos_train"] = timed(lambda: ops.flash_dq_pos_cuda(*pbwd))
        res["k8pos_train"] = timed(lambda: ops.flash_dkv_pos_cuda(*pbwd))
        outs["k7pos_train"] = ops.flash_dq_pos_cuda(*pbwd)
        outs["k8pos_train"] = ops.flash_dkv_pos_cuda(*pbwd)[0]
        rq, rk, rv, rdo, rqpos, rkpos = sp
        rout, rlse = ops.flash_attention_pos_cuda(rq, rk, rv, rqpos, rkpos, return_lse=True)
        rdelta = (rdo.float() * rout.float()).sum(-1).transpose(1, 2).contiguous()
        rbwd = (rq, rk, rv, rdo, rlse, rdelta, rqpos, rkpos)
        res["k7pos_sp"] = timed(lambda: ops.flash_dq_pos_cuda(*rbwd))
        res["k8pos_sp"] = timed(lambda: ops.flash_dkv_pos_cuda(*rbwd))
        outs["k7pos_sp"] = ops.flash_dq_pos_cuda(*rbwd)
        outs["k8pos_sp"] = ops.flash_dkv_pos_cuda(*rbwd)[0]
        del rout, rlse, rdelta, rbwd
    pq, pk, pv, pkw = pos
    args = (pq, pk, pv, pkw["q_positions"], pkw["kv_positions"])
    seg_kw = dict(q_segment_ids=pkw["q_segment_ids"], kv_segment_ids=pkw["kv_segment_ids"],
                  seg_pad_zero=True)
    res["k3pos"] = timed(lambda: ops.flash_attention_pos_cuda(*args, **seg_kw))
    if splits:
        grid_splits = att.grid_splits
        try:
            for n in splits:
                att.grid_splits = lambda *a, n=n: n
                res[f"k3pos_splits_{n}"] = timed(
                    lambda: ops.flash_attention_pos_cuda(*args, **seg_kw))
        finally:
            att.grid_splits = grid_splits
    return res, outs


def pooled(readings):
    """{tree: {row: {metric: {median, min, max, n}}}} over the (tree, rows)
    readings, every round and every listing of a tree together."""
    vals = {}
    for tree, rws in readings:
        for row, metrics in rws.items():
            if isinstance(metrics, dict):
                for key, x in metrics.items():
                    vals.setdefault(tree, {}).setdefault(row, {}).setdefault(key, []).append(x)
    return {tree: {row: {key: {"median": statistics.median(xs), "min": min(xs), "max": max(xs),
                               "n": len(xs)} for key, xs in metrics.items()}
                   for row, metrics in rws.items()}
            for tree, rws in vals.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--tree", action="append",
                        help="checkout holding orion_tpu_torch (repeatable; default: this one)")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--splits", default="",
                        help="comma-separated split counts of K3-pos to time in the last tree")
    args = parser.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    trees = args.tree or [HERE]
    loaded = {tree: load_ops(tree) for tree in trees}
    splits = [int(s) for s in args.splits.split(",") if s]
    gen = torch.Generator(device="cuda")
    readings = []
    for i in range(args.rounds):
        gen.manual_seed(i)
        serve = cs.k3_inputs(torch.bfloat16, gen)
        train = cs.t_attn_inputs(torch.bfloat16, gen)
        pos = cs.k3pos_gather_inputs(torch.bfloat16, gen)
        striped = cs.k3pos_striped_inputs(torch.bfloat16, gen)
        sp = cs.sp_step_inputs(gen)
        pq, pk, pv, pkw = pos
        mask = loaded[trees[-1]][0].attention_mask(pq.shape[1], pk.shape[1], causal=True,
                                                   **pkw)[:, None]
        lib = [t.transpose(1, 2) for t in (pq, pk, pv)]
        rnd, first = {}, {}
        for j, tree in enumerate(trees):
            ops, att = loaded[tree]
            r, outs = rows(ops, att, (serve, train, pos, striped, sp),
                           splits if tree == trees[-1] else [])
            for name, t in outs.items():
                if name not in first:
                    first[name] = t
                elif "pos" in name:
                    r[f"{name}_max_abs_diff_first_tree"] = cs.max_err(t, first[name])
                else:
                    r[f"{name}_bitwise_first_tree"] = bool(torch.equal(cs.bits(t),
                                                                       cs.bits(first[name])))
            n = trees[:j].count(tree)
            rnd[f"{tree}#{n}" if n else tree] = r
            readings.append((tree, r))
        rnd["sdpa_pos"] = {"sdpa": timed(lambda: F.scaled_dot_product_attention(
            *lib, attn_mask=mask, enable_gqa=True))}
        readings.append(("sdpa_pos", rnd["sdpa_pos"]))
        del serve, train, pos, striped, sp, pq, pk, pv, pkw, mask, lib, first
        torch.cuda.empty_cache()
        print(json.dumps({"round": i, **rnd}), flush=True)
    print(json.dumps({"summary": pooled(readings), "rounds": args.rounds}), flush=True)
    print(cs.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
