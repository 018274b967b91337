"""Generation entry point of the port: continuous-batching inference over
the paged KV cache, on the GPU by default.

Usage:
    python -m orion_tpu_torch.generate --preset llama3-8b-infer \\
        --tokens "5,3,9" [--tokens "..."] [--device cuda] [key=value ...]

Each ``--tokens`` list is one request, served concurrently; one JSON
line per request, with its typed outcome beside its tokens, is printed at
the end. On SIGTERM the loop drains at the next step boundary: admission
stops, never-started requests are shed, live ones finish, and the process
exits 0. Weights are the params of the newest intact trainer checkpoint
in ``checkpoint.directory`` (this package's or the JAX package's: the
format is the same), cast to the model's dtype; without one, a seeded
random init in the model's dtype, made on the device (``--seed``), which
exercises the whole engine, scheduler, cache and kernel path, not output
quality.
Dotted ``key=value`` arguments override the preset (sampling:
``inference.temperature=0.7 inference.top_k=50``).

``--regex PATTERN`` or ``--json-schema FILE`` constrains every request's
output to the grammar (byte-level patterns over the byte tokenizer, token
id == byte value); either sets ``inference.constrained=true``.

``--trace PATH`` records the serve's spans and lifecycle events and
exports them as a Chrome trace (Perfetto; ``python tools/obs_report.py
PATH`` renders it in the terminal); ``--flight-dir DIR`` writes
flight-recorder postmortems there on a degradation (failed steps, a NaN
quarantine, a watchdog stall, speculation switching itself off). Sugar for
``inference.trace=true inference.trace_path=PATH`` and
``inference.flight_dir=DIR``; ``inference.metrics_jsonl`` and
``inference.metrics_prom`` export the metrics registry.

Tensor-parallel serving (``parallel.tp`` > 1, with ``dp`` replicas beside
it): one process a device, started by ``torchrun`` (or with
``runtime.coordinator_address``, ``num_processes`` and ``process_id``);
each process cuts its blocks out of the weights
(``models.convert.serving_blocks``), runs its engine eagerly (CUDA graphs
refuse tp) and rank 0 prints the results, e.g.
``torchrun --nproc_per_node=2 -m orion_tpu_torch.generate --preset
tiny-llama --device cpu --tokens "5,3,9" parallel.tp=2``.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    parser.add_argument("--preset", default="tiny-llama")
    parser.add_argument("--tokens", action="append", default=[],
                        help="comma-separated token ids (one per request)")
    parser.add_argument("--max-new-tokens", type=int, default=None)
    parser.add_argument("--eos-id", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random weights and of sampling")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; 'cpu' runs the "
                             "plain PyTorch versions of the kernels)")
    parser.add_argument("--regex", default=None, metavar="PATTERN",
                        help="grammar-constrained decoding: every request emits "
                             "only tokens the regex's FSM admits (mutually "
                             "exclusive with --json-schema)")
    parser.add_argument("--json-schema", default=None, metavar="FILE",
                        help="grammar-constrained decoding from a JSON Schema "
                             "file, compiled to a regex and then to the same "
                             "token-level FSM (mutually exclusive with --regex)")
    parser.add_argument("--trace", metavar="PATH", default=None,
                        help="export a Chrome trace-event JSON of the serve to PATH "
                             "(lifecycle instants and per-dispatch spans; load in "
                             "Perfetto); sugar for inference.trace=true + "
                             "inference.trace_path=PATH")
    parser.add_argument("--flight-dir", metavar="DIR", default=None,
                        help="flight-recorder postmortems: on a degradation trigger "
                             "(step faults, NaN quarantine, watchdog stall, "
                             "speculation switched off) write the fault-adjacent "
                             "span window to DIR; sugar for inference.flight_dir=DIR "
                             "(render with tools/obs_report.py)")
    parser.add_argument("overrides", nargs="*", help="dotted config overrides")
    args = parser.parse_args(argv)
    overrides = list(args.overrides)
    if args.trace is not None:
        overrides += ["inference.trace=true", f"inference.trace_path={args.trace}"]
    if args.flight_dir is not None:
        overrides.append(f"inference.flight_dir={args.flight_dir}")
    constraint = _constraint(args)
    if constraint is not None:
        overrides.append("inference.constrained=true")

    from orion_tpu_torch.config import get_config
    from orion_tpu_torch.infer import InferenceEngine
    from orion_tpu_torch.infer.engine import resolve_device
    from orion_tpu_torch.runtime.distributed import join, process_index
    from orion_tpu_torch.runtime.fault import PreemptionHandler

    cfg = get_config(args.preset, overrides)
    device = resolve_device(args.device)
    prompts = [[int(t) for t in spec.split(",")] for spec in args.tokens]
    if not prompts:
        prompts = [[1, 2, 3, 4]]

    ranks = cfg.parallel.num_devices > 1
    if ranks:
        device = join(cfg.runtime, device)
    params = _params(cfg, device, args.seed)
    if ranks:
        from orion_tpu_torch.models.convert import serving_blocks
        from orion_tpu_torch.runtime.mesh import rank_coords

        sizes = cfg.parallel.axis_sizes
        params = serving_blocks(params, cfg.model, sizes, rank_coords(process_index(), sizes))
    engine = InferenceEngine(cfg, params, eos_id=args.eos_id, seed=args.seed,
                             device=device, cuda_graphs=not ranks)
    del params
    # Graceful shutdown: SIGTERM only flips a flag; at the next step
    # boundary the engine stops admission, sheds the never-started queue
    # with typed outcomes and finishes every live request.
    with PreemptionHandler() as handler:
        reqs = [engine.submit_request(p, args.max_new_tokens, constraint=constraint)
                for p in prompts]
        while engine.has_work():
            if handler.preempted:
                print("SIGTERM: draining (admission stopped, live requests finishing)",
                      flush=True)
                engine.drain()
                break
            engine.step()
    engine.close()
    if args.trace:
        # Exported again, so the message counts this run's events (a stale
        # file from an earlier serve must not pass for this one's).
        try:
            n = engine.export_trace(args.trace)
            print(f"trace written to {args.trace}: {n} events (open in Perfetto, "
                  f"or run tools/obs_report.py {args.trace})")
        except OSError as e:
            print(f"trace export to {args.trace} failed: {e}", file=sys.stderr)
    if engine.mesh is not None and engine.mesh.get_rank() != 0:
        return 0
    for req in reqs:
        print(json.dumps({"rid": req.rid, "outcome": req.outcome,
                          "prompt": req.prompt, "generated": req.generated}))
    return 0


def _params(cfg, device, seed: int):
    """The params of the newest intact checkpoint in
    ``checkpoint.directory`` (the moments dropped), else a seeded init; in
    the model's dtype on ``device``."""
    import torch

    from orion_tpu_torch.models import init_params
    from orion_tpu_torch.models.convert import to_device, unstack_layers

    if cfg.checkpoint.directory:
        from orion_tpu_torch.ckpt import CheckpointManager
        from orion_tpu_torch.train.trainer import abstract_train_state

        restored = CheckpointManager(cfg.checkpoint.directory, cfg.checkpoint) \
            .restore_latest(abstract_train_state(cfg))
        if restored is not None:
            tree, step = restored
            print(f"restored checkpoint step {step}")
            return to_device(unstack_layers(tree["params"], cfg.model), device,
                             dtype=cfg.model.dtype)
        print(f"no intact checkpoint in {cfg.checkpoint.directory}: serving the "
              f"seeded init (--seed {seed})")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return init_params(cfg.model, gen, device=device, dtype=cfg.model.dtype)


def _constraint(args):
    """The ConstraintSpec of ``--regex`` / ``--json-schema``, or None; a
    malformed pattern or schema, or an unreadable schema file, exits with
    the reason before any engine is built."""
    if args.regex is not None and args.json_schema is not None:
        raise SystemExit(
            "--regex and --json-schema are mutually exclusive (one grammar per request)")
    if args.regex is None and args.json_schema is None:
        return None
    from orion_tpu_torch.constrain import ConstraintError, ConstraintSpec, compile_regex

    try:
        if args.regex is not None:
            spec = ConstraintSpec(regex=args.regex)
        else:
            try:
                with open(args.json_schema, encoding="utf-8") as f:
                    schema_text = f.read()
            except OSError as e:
                raise SystemExit(f"--json-schema {args.json_schema}: {e}")
            spec = ConstraintSpec(json_schema=schema_text)
        # pattern() parses the schema frontend; compile_regex the regex.
        compile_regex(spec.pattern())
    except ConstraintError as e:
        raise SystemExit(f"invalid constraint: {e}")
    return spec


if __name__ == "__main__":
    sys.exit(main())
