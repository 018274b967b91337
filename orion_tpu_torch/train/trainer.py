"""The training step loop on one GPU, or over a sequence-parallel mesh of
GPUs, with checkpoints and the training-side fault stack.

Counterpart of ``orion_tpu/train/trainer.py`` (``Trainer.fit`` ->
``make_train_step`` -> ``models.transformer.loss_fn``) for a single
device: float32 master parameters (``model.param_dtype``), compute in
``model.dtype`` (weights cast at use), autograd through the port's ops —
on the card RMSNorm (K1/K5), RoPE (K2/K6) and flash attention (K3/K7/K8)
run their hand-written kernels — then clipping and the AdamW update in
place. Gradient accumulation splits the global batch into
``train.grad_accum`` microbatches; ``train.grad_dtype`` takes the
gradients with respect to a parameter copy in that dtype.

Fault tolerance, as in the JAX package: checkpoints in its on-disk format
(``ckpt/``; the state travels in its layout, ``state_to_tree``), resume
from the newest intact one, the gradient anomaly guard
(``train.anomaly_guard``: a non-finite or spiking step is skipped, its
params and moments untouched) with auto-rollback after
``train.anomaly_limit`` consecutive anomalies, the emergency save on
SIGTERM, on an injected fault and on KeyboardInterrupt
(``train.emergency_ckpt``), the stall watchdog, ``inject_fault_at_step``
and a ``FaultInjector``'s "dispatch", "nan" and "partial_write" kinds.
Supervisor restarts are ``runtime.fault.run_with_restarts`` around a
fresh Trainer (``python -m orion_tpu_torch.train --max-restarts N``).

Sequence parallelism (``parallel.sp`` > 1, as the JAX trainer routes it,
``orion_tpu/train/trainer.py:672-711``): one process per rank of the
``sp`` axis (``torchrun --nproc_per_node=<sp>``, or
``runtime.coordinator_address`` / ``num_processes`` / ``process_id``),
joined by ``runtime.distributed.initialize`` (NCCL on the card, gloo on
the CPU) into a ``runtime.mesh`` mesh. Every rank reads the same global
batch and keeps its contiguous sequence slice of the inputs, targets,
loss mask, segment ids and positions (global positions where the batch
has none); attention runs as ``parallel.sequence_attention`` with
``parallel.sequence_method``; the loss is the global token mean (each
rank backpropagates its share, ``models.transformer.loss_fn``); the
gradients are summed over ``sp`` before clipping and AdamW, so every
rank applies the same update and the parameters stay identical. Logs
and the metrics file come from rank 0.

Observability (``orion_tpu_torch/obs``, the JAX trainer's wiring): a
metrics registry (sections robust, train: the newest step's metrics, and
hbm); with ``train.trace``, ``trace_path`` or ``flight_dir`` the spans
``data``, ``dispatch`` (inside a ``train#<step>`` profiler range),
``guard``, ``ckpt`` and ``train_step`` per step, exported as a Chrome trace
to ``trace_path`` when ``fit`` ends; with ``flight_dir`` a postmortem at an
anomaly rollback; ``metrics_prom`` every ``log_interval`` steps and at the
end; ``profile_steps=(a, b)`` a ``torch.profiler`` capture of steps a to
b - 1 (CPU activity, and CUDA activity on the card), its Chrome trace
written under ``profile_dir``. At ``parallel.sp`` > 1 these act on rank 0
only.

Not ported yet, and rejected at construction (``_check_supported``):
ZeRO-1 and quantized gradient collectives, evaluation, every parallel axis other than
sp above 1 (``runtime.mesh.check_axes`` names the mode), more processes
than one per sequence-parallel rank, checkpoints, the anomaly guard and
fault injection at sp > 1 (the multi-process checkpoint save comes with
the DDP/FSDP slice), MoE, weight quantization, checkify, debug asserts,
``runtime.debug_nans`` and ``runtime.deterministic``, and remat policies
other than none/full.

The trainer runs on ``cuda`` unless the caller passes ``device="cpu"``
(the plain PyTorch versions of the kernels); with no device given and no
GPU present it raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from orion_tpu_torch import metrics as metrics_lib
from orion_tpu_torch.ckpt import CheckpointManager
from orion_tpu_torch.comm.collectives import all_reduce
from orion_tpu_torch.config import Config, ModelConfig
from orion_tpu_torch.data import make_loader
from orion_tpu_torch.infer.engine import resolve_device
from orion_tpu_torch.models.convert import (
    init_params,
    stack_layers,
    to_device,
    tree_leaves,
    tree_map,
    tree_unflatten,
    unstack_layers,
)
from orion_tpu_torch.models.transformer import loss_fn, torch_dtype
from orion_tpu_torch.obs import MetricsRegistry, export_chrome_safe, init_obs, live_hbm_metrics
from orion_tpu_torch.runtime.distributed import initialize, process_index
from orion_tpu_torch.runtime.mesh import build_mesh, check_axes
from orion_tpu_torch.runtime.fault import (
    TRAIN_KINDS,
    InjectedFault,
    Preempted,
    PreemptionHandler,
    Watchdog,
)
from orion_tpu_torch.train.optimizer import (
    apply_updates,
    global_norm,
    init_opt_state,
    make_schedule,
    tree_all_finite,
)

log = logging.getLogger("orion_tpu_torch.train")

TrainState = dict[str, Any]


class FaultInjected(RuntimeError):
    """Raised by the ``train.inject_fault_at_step`` test hook."""


class RollbackFailed(RuntimeError):
    """Auto-rollback (``train.anomaly_limit`` consecutive anomalies) found
    no intact checkpoint to restore."""


# Each injected fault fires once per (checkpoint dir, step) per process, so
# a supervisor restart that resumes from before the fault step does not
# crash again on the same hook: a transient failure, as in the JAX package.
_FIRED_FAULTS: set = set()


def _check_supported(cfg: Config) -> None:
    m, t, r = cfg.model, cfg.train, cfg.runtime
    sp = cfg.parallel.sp
    remat = t.remat if t.remat != "inherit" else m.remat
    unsupported = {
        "train.zero1": t.zero1,
        "train.zero1_quantize": t.zero1_quantize is not None,
        "train.grad_quant_bits": t.grad_quant_bits is not None,
        "train.eval_interval": t.eval_interval is not None,
        f"remat={remat!r} (none|full are ported)": remat not in ("none", "full"),
        "remat_offload": t.remat_offload or m.remat_offload,
        "model.n_experts > 0 (MoE)": m.is_moe,
        "model.weight_quant": m.weight_quant is not None,
        "runtime.checkify": r.checkify,
        "runtime.debug_nans": r.debug_nans,
        "runtime.deterministic": r.deterministic,
        "runtime.num_processes > 1 other than one a sequence-parallel rank": (
            r.num_processes > 1 and r.num_processes != sp),
        "checkpoint.directory with parallel.sp > 1": sp > 1 and bool(cfg.checkpoint.directory),
        "train.anomaly_guard / inject_fault_at_step with parallel.sp > 1": sp > 1 and (
            t.anomaly_guard or t.inject_fault_at_step is not None),
        "model.debug_asserts": m.debug_asserts,
    }
    bad = [name for name, on in unsupported.items() if on]
    if bad:
        raise NotImplementedError(
            f"not ported to orion_tpu_torch yet: {', '.join(bad)}"
        )
    check_axes(cfg.parallel)


def sequence_parallel_config(cfg: Config) -> Config:
    """At ``parallel.sp`` > 1, validate as the JAX trainer does (the
    sequence length divisible by sp; Ulysses' head counts, with its warning
    where grouped kv heads replicate) and route attention through the
    ``sp`` axis (``model.sequence_axis`` / ``sequence_method``)."""
    p = cfg.parallel
    if p.sp <= 1:
        return cfg
    if cfg.data.seq_len % p.sp:
        raise ValueError(f"data.seq_len={cfg.data.seq_len} must be divisible by "
                         f"parallel.sp={p.sp}")
    if p.sequence_method == "ulysses":
        sp_tp = p.sp * p.tp
        if cfg.model.n_heads % sp_tp:
            raise ValueError(f"ulysses needs model.n_heads={cfg.model.n_heads} "
                             f"divisible by sp*tp={sp_tp}")
        kv = cfg.model.n_kv_heads
        if kv < sp_tp and sp_tp % kv == 0:
            log.warning(
                "ulysses with GQA (kv_heads=%d < sp*tp=%d) replicates KV heads: %dx "
                "KV all_to_all volume. parallel.sequence_method='ring' (or "
                "'ring_striped') avoids the inflation for this config.",
                kv, sp_tp, sp_tp // kv)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, sequence_axis="sp", sequence_method=p.sequence_method))


def _check_injector(injector, sp: int = 1) -> None:
    """Refuse a fault schedule holding kinds training does not consume, and
    any schedule at sp > 1."""
    if injector is None:
        return
    if sp > 1:
        raise NotImplementedError(
            "not ported to orion_tpu_torch yet: fault injection with parallel.sp > 1")
    bad = sorted({s.kind for s in injector.specs if s.kind not in TRAIN_KINDS})
    if bad:
        raise NotImplementedError(
            f"not ported to orion_tpu_torch yet: fault kinds {', '.join(bad)} "
            f"(the trainer consumes {', '.join(TRAIN_KINDS)})"
        )


def prng_key_data(seed: int) -> list[int]:
    """``jax.random.key_data(jax.random.key(seed))`` as the JAX package
    records it in every manifest (threefry, 32-bit seeds): [0, seed mod
    2**32]."""
    return [0, seed & 0xFFFFFFFF]


def state_to_tree(state: TrainState, mcfg: ModelConfig) -> dict:
    """The train state in the JAX trainer's layout, the one checkpoints
    hold: params and moments with their blocks stacked (``scan_layers``),
    ``opt.count`` and ``step`` as 0-d int32 tensors."""
    opt = state["opt"]
    return {
        "params": stack_layers(state["params"], mcfg),
        "opt": {
            "count": torch.tensor(opt["count"], dtype=torch.int32),
            "mu": stack_layers(opt["mu"], mcfg),
            "nu": stack_layers(opt["nu"], mcfg),
        },
        "step": torch.tensor(state["step"], dtype=torch.int32),
    }


def state_from_tree(tree: dict, mcfg: ModelConfig, device) -> TrainState:
    """The inverse of ``state_to_tree``, on ``device`` (each leaf moved
    there before the layers are split)."""
    opt = tree["opt"]

    def layers(t):
        return unstack_layers(to_device(t, device), mcfg)

    return {
        "params": layers(tree["params"]),
        "opt": {"mu": layers(opt["mu"]), "nu": layers(opt["nu"]),
                "count": int(opt["count"])},
        "step": int(tree["step"]),
    }


def abstract_train_state(cfg: Config) -> dict:
    """The checkpoint tree of a train state on the ``meta`` device: the
    shapes and dtypes a restore validates against, with no memory."""
    params = init_params(cfg.model, torch.Generator(), device="meta",
                         dtype=torch_dtype(cfg.model.param_dtype))
    state = {"params": params, "opt": init_opt_state(params, cfg.optimizer), "step": 0}
    return state_to_tree(state, cfg.model)


def init_train_state(
    cfg: Config, device, params: Optional[Any] = None
) -> TrainState:
    """Params in ``model.param_dtype`` on ``device`` (a seeded random init
    from ``train.seed``, or a copy of ``params``), fresh optimizer state
    and step 0."""
    pdt = torch_dtype(cfg.model.param_dtype)
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(cfg.train.seed)
        params = init_params(cfg.model, gen, device=device, dtype=pdt)
    else:
        params = tree_map(lambda t: t.to(device=device, dtype=pdt, copy=True), params)
    return {"params": params, "opt": init_opt_state(params, cfg.optimizer), "step": 0}


def loss_and_grads(
    params: Any,
    batch: dict[str, torch.Tensor],
    mcfg: ModelConfig,
    accum: int = 1,
    grad_dtype: Optional[str] = None,
    poison: bool = False,
    mesh=None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor], Any]:
    """(loss, aux, grads) of ``loss_fn``; ``grads`` is a tree like
    ``params``. With ``accum`` > 1 the batch leaves are [accum, b, S]
    microbatches: grads and loss are means over them (float32
    accumulators), token counts sum. With ``grad_dtype`` the gradients
    are taken with respect to a copy of the parameters in that dtype.
    ``poison`` multiplies the loss by NaN inside the differentiated
    function, so NaNs flow through the real backward into every gradient
    (the fault injector's "nan" kind). Under sequence parallelism
    (``mesh``) ``batch`` is this rank's sequence slice; the loss, its aux
    terms and the gradients come back summed over ``sp`` (the global
    values, the same on every rank)."""

    def value_and_grad(mb):
        leaves = [
            p.detach().to(torch_dtype(grad_dtype) if grad_dtype else p.dtype)
            .requires_grad_(True)
            for p in tree_leaves(params)
        ]
        loss, aux = loss_fn(tree_unflatten(params, leaves), mb, mcfg, mesh)
        if poison:
            loss = loss * torch.tensor(float("nan"), dtype=loss.dtype, device=loss.device)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, list(grads)

    if accum == 1:
        loss, aux, grads = value_and_grad(batch)
        return _sum_over_sp(loss, aux, grads, mcfg, mesh, params)
    acc = [torch.zeros_like(p) for p in tree_leaves(params)]
    loss_sum = aux_sum = None
    for i in range(accum):
        loss, aux, grads = value_and_grad({k: v[i] for k, v in batch.items()})
        for a, g in zip(acc, grads):
            a.add_(g)
        loss_sum = loss if loss_sum is None else loss_sum + loss
        aux_sum = aux if aux_sum is None else {k: aux_sum[k] + aux[k] for k in aux}
        del grads
    inv = 1.0 / accum
    for a in acc:
        a.mul_(inv)
    # Means over microbatches, except token counts, which accumulate.
    aux = {k: v if k == "tokens" else v * inv for k, v in aux_sum.items()}
    return _sum_over_sp(loss_sum * inv, aux, acc, mcfg, mesh, params)


def _sum_over_sp(loss, aux, grads, mcfg: ModelConfig, mesh, params):
    """(loss, aux, grads as a tree): each rank's shares summed over the
    ``sp`` axis when sequence parallelism is on (token counts are global
    already), as they are otherwise. The gradients travel as one flat
    buffer per dtype."""
    if mesh is None or mcfg.sequence_axis is None:
        return loss, aux, tree_unflatten(params, grads)
    group = mesh.get_group(mcfg.sequence_axis)
    with torch.no_grad():
        for dtype in sorted({g.dtype for g in grads}, key=str):
            idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
            flat = all_reduce(torch.cat([grads[i].reshape(-1) for i in idx]), group)
            for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
                grads[i] = part.view_as(grads[i])
        scalars = all_reduce(torch.stack([loss.float(), aux["ce_loss"].float(),
                                          aux["moe_aux"].float()]), group)
    aux = dict(aux, ce_loss=scalars[1], moe_aux=scalars[2])
    return scalars[0], aux, tree_unflatten(params, grads)


def make_train_step(
    cfg: Config, schedule: Callable[[int], float], poison: bool = False, mesh=None
) -> Callable[..., tuple[TrainState, dict]]:
    """The per-step function: forward + backward (+ accumulation), clip
    and AdamW/SGD update in place. Returns (state, step metrics as host
    floats, fetched from the card in one copy).

    With ``train.anomaly_guard`` the returned callable takes a third
    ``norm_limit`` (the host-kept spike threshold, float32). The loss's and
    every gradient leaf's finiteness and the global grad norm travel to the
    host with the metrics, before the update: an anomalous step (non-finite,
    or a norm above ``norm_limit``) is not applied, so params and moments
    stay bit-identical and the schedule count does not advance; the
    metrics carry ``anomaly``/``nonfinite``/``spike`` flags. A clean
    guarded step runs the same operations as an unguarded one.
    ``poison=True`` builds the fault injector's "nan" variant
    (``loss_and_grads(poison=True)``). ``mesh`` is the sequence-parallel
    mesh (the batch then this rank's slice).
    """
    accum, gdt = cfg.train.grad_accum, cfg.train.grad_dtype

    def grads_of(state: TrainState, batch: dict):
        lr = schedule(state["opt"]["count"])
        loss, aux, grads = loss_and_grads(state["params"], batch, cfg.model, accum, gdt,
                                          poison=poison, mesh=mesh)
        return lr, loss, aux, grads

    def fetch(*scalars: torch.Tensor) -> list[float]:
        """The step's one device-to-host copy."""
        return torch.stack([x.float() for x in scalars]).tolist()

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        lr, loss, aux, grads = grads_of(state, batch)
        _, _, opt_metrics = apply_updates(
            state["params"], grads, state["opt"], cfg.optimizer, lr)
        state["step"] += 1
        loss, ce, moe, gnorm = fetch(loss, aux["ce_loss"], aux["moe_aux"],
                                     opt_metrics["grad_norm"])
        return state, {"loss": loss, "ce_loss": ce, "moe_aux": moe, "grad_norm": gnorm,
                       "lr": lr}

    if not cfg.train.anomaly_guard:
        return train_step

    def guarded_step(state: TrainState, batch: dict, norm_limit) -> tuple[TrainState, dict]:
        lr, loss, aux, grads = grads_of(state, batch)
        gnorm = global_norm(grads)
        finite = torch.isfinite(loss) & tree_all_finite(grads).to(loss.device)
        loss_h, ce, moe, gnorm_h, finite_h = fetch(loss, aux["ce_loss"], aux["moe_aux"],
                                                   gnorm, finite)
        finite_h = finite_h > 0
        # float32 against float32, as the JAX step compares on the device.
        spike = finite_h and gnorm_h > float(np.float32(norm_limit))
        ok = finite_h and not spike
        if ok:
            apply_updates(state["params"], grads, state["opt"], cfg.optimizer, lr,
                          gnorm=gnorm)
        state["step"] += 1
        return state, {
            "loss": loss_h, "ce_loss": ce, "moe_aux": moe, "grad_norm": gnorm_h, "lr": lr,
            "anomaly": float(not ok), "nonfinite": float(not finite_h),
            "spike": float(spike),
        }

    return guarded_step


class Trainer:
    """Builds the loader, the state and the step, and runs the fit loop.

    ``params`` (a parameter tree, e.g. ``models.from_jax_params`` of the
    JAX package's init) replaces the seeded random init; ``device`` is a
    torch device (default ``cuda``); ``fault_injector`` is a
    ``runtime.fault.FaultInjector`` whose "dispatch" and "nan" specs on
    path "train" fire at a step, and whose "partial_write" specs tear a
    checkpoint commit."""

    def __init__(self, cfg: Config, params: Optional[Any] = None, device=None,
                 fault_injector: Optional[Any] = None):
        if cfg.train.remat != "inherit":
            # train.remat is the training-side spelling of model.remat.
            cfg = dataclasses.replace(
                cfg, model=dataclasses.replace(cfg.model, remat=cfg.train.remat))
        _check_supported(cfg)
        _check_injector(fault_injector, cfg.parallel.sp)
        cfg = sequence_parallel_config(cfg)
        accum = max(cfg.train.grad_accum, 1)
        if cfg.data.batch_size % accum:
            raise ValueError(
                f"grad_accum={cfg.train.grad_accum} must divide global batch "
                f"{cfg.data.batch_size}"
            )
        self.cfg = cfg
        self.device = resolve_device(device)
        # The sequence-parallel mesh (None at sp = 1) and this rank on it.
        self.mesh, self.sp_rank = None, 0
        if cfg.parallel.sp > 1:
            initialize(cfg.runtime, self.device)
            if self.device.type == "cuda" and self.device.index is None:
                local = int(os.environ.get("LOCAL_RANK",
                                           process_index() % torch.cuda.device_count()))
                self.device = torch.device("cuda", local)
                torch.cuda.set_device(self.device)
            self.mesh = build_mesh(cfg.parallel, self.device)
            self.sp_rank = self.mesh.get_local_rank("sp")
        self.fault_injector = fault_injector
        self._params = params
        self.loader = make_loader(cfg.data, cfg.model.vocab_size)
        self._schedule = make_schedule(cfg.optimizer, cfg.train.num_steps)
        self.train_step = make_train_step(cfg, self._schedule, mesh=self.mesh)
        self._poison_step = None
        self.ckpt: Optional[CheckpointManager] = None
        if cfg.checkpoint.directory:
            self.ckpt = CheckpointManager(cfg.checkpoint.directory, cfg.checkpoint,
                                          fault_injector=fault_injector)
        # Anomaly-guard host state (persisted in the checkpoint manifest so a
        # resume reproduces the same skip decisions) and the counters.
        self._gnorm_ema: Optional[float] = None
        self._anomaly_run = 0
        self.robustness = metrics_lib.TrainRobustnessStats()
        # The JAX package's record of the seed's PRNG key, checked on resume.
        self._prng_key_data = prng_key_data(cfg.train.seed)
        # data.batch_size is the global batch per optimizer step; grad_accum
        # only splits it into microbatches.
        self.tokens_per_step = cfg.data.batch_size * cfg.data.seq_len
        peak = cfg.train.peak_flops_per_device or metrics_lib.peak_flops_per_device(
            self.device)
        lead = self.sp_rank == 0   # logs and the metrics file come from rank 0
        self.metrics = metrics_lib.MetricsLogger(
            flops_per_token=cfg.model.flops_per_token(cfg.data.seq_len),
            num_devices=cfg.parallel.sp,
            peak_flops=peak,
            jsonl_path=cfg.train.metrics_jsonl if lead else None,
            log_interval=cfg.train.log_interval if lead else 2 ** 62,
        )
        # -- Observability (orion_tpu_torch/obs) ---------------------------
        # The registry always (lazy reads); the tracer and the flight
        # recorder only when asked for, and only on rank 0, like the logs.
        self._lead = lead
        self.registry = MetricsRegistry()
        self.registry.register("robust", lambda: self.robustness.as_timing())
        self.registry.register("train", self._last_step_metrics)
        self.registry.register("hbm", lambda: live_hbm_metrics(self.device))
        t = cfg.train
        self._tracer, self._flight = init_obs(
            trace=t.trace and lead, trace_ring=t.trace_ring,
            flight_dir=t.flight_dir if lead else None,
            trace_path=t.trace_path if lead else None,
            snapshot=self.registry.snapshot, injector=fault_injector, device=self.device,
        )

    def _last_step_metrics(self) -> dict:
        """Registry provider: the newest step's metrics (the row the JSONL
        sink writes), or {} before the first step."""
        h = self.metrics.history
        return h[-1].to_dict() if h else {}

    def _flight_dump(self, reason: str, **context) -> None:
        """A flight-recorder postmortem (a no-op without train.flight_dir);
        best-effort, as the engine's (``FlightRecorder.try_dump``)."""
        if self._flight is not None:
            self._flight.try_dump(reason, **context)

    def _export_prom(self) -> None:
        """The registry as a Prometheus textfile (train.metrics_prom, rank 0);
        a write failure is logged, never raised."""
        if self.cfg.train.metrics_prom and self._lead:
            try:
                self.registry.export_prometheus(self.cfg.train.metrics_prom)
            except OSError as e:
                log.error("metrics_prom export failed: %s", e)

    def _start_profile(self):
        """A ``torch.profiler`` capture for the train.profile_steps window:
        CPU activity, and CUDA activity on the card."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        return prof

    def _stop_profile(self, prof) -> None:
        """Stop the capture and write its Chrome trace under
        train.profile_dir."""
        prof.stop()
        first, last = self.cfg.train.profile_steps
        os.makedirs(self.cfg.train.profile_dir, exist_ok=True)
        path = os.path.join(self.cfg.train.profile_dir, f"train_{first}_{last}.trace.json")
        prof.export_chrome_trace(path)
        log.info("train.profile_steps: profiler trace of steps %d-%d -> %s",
                 first, last - 1, path)

    # -- state ------------------------------------------------------------

    def init_state(self) -> TrainState:
        return init_train_state(self.cfg, self.device, self._params)

    def restore_or_init(self) -> tuple[TrainState, int]:
        """The newest intact checkpoint's state (``checkpoint.restore``),
        else a fresh ``init_state()``; and its step."""
        if self.ckpt is not None and self.cfg.checkpoint.restore:
            restored = self.ckpt.restore_latest(abstract_train_state(self.cfg))
            self.robustness.corrupt_checkpoints += len(self.ckpt.quarantined)
            if restored is not None:
                tree, step = restored
                self._apply_restore_extra(self.ckpt.last_restore_extra)
                return state_from_tree(tree, self.cfg.model, self.device), step
        return self.init_state(), 0

    def _apply_restore_extra(self, extra: Optional[dict]) -> None:
        """Rehydrate the host-side resume state the manifest carried:
        data-loader cursor, anomaly-guard EMA/run, PRNG-lineage check."""
        if not extra:
            return
        if extra.get("loader"):
            loader_state = dict(extra["loader"])
            # The manifest-level stream-format check already warned on a
            # mismatch; don't let load_state_dict repeat it.
            loader_state.pop("stream_format", None)
            self.loader.load_state_dict(loader_state)
        if "gnorm_ema" in extra:
            self._gnorm_ema = extra["gnorm_ema"]
        self._anomaly_run = int(extra.get("anomaly_run") or 0)
        key = extra.get("prng_key")
        if key is not None and list(key) != self._prng_key_data:
            log.warning(
                "checkpoint was written under a different train.seed PRNG "
                "key (%s vs %s): any key-derived randomness diverges from "
                "the original run", key, self._prng_key_data,
            )

    def _ckpt_extra(self) -> dict:
        extra = {
            "loader": self.loader.state_dict(),
            "train_seed": self.cfg.train.seed,
            "prng_key": self._prng_key_data,
        }
        if self.cfg.train.anomaly_guard:
            extra["gnorm_ema"] = self._gnorm_ema
            extra["anomaly_run"] = self._anomaly_run
        return extra

    def _save(self, step: int, state: TrainState, **kw) -> bool:
        """``ckpt.save`` of the state in the checkpoint layout, built only
        when the step is saved."""
        return self.ckpt.save(step, lambda: state_to_tree(state, self.cfg.model),
                              extra=self._ckpt_extra(), **kw)

    def _spike_limit(self) -> np.float32:
        """The norm threshold fed to the guarded step: factor x the
        running EMA, or +inf while no reference exists (first steps, or
        spike checking disabled — finiteness is still checked)."""
        factor = self.cfg.train.anomaly_spike_factor
        if factor is None or not self._gnorm_ema:
            return np.float32(np.inf)
        return np.float32(factor * self._gnorm_ema)

    def _guard_update(self, step: int, m: dict) -> None:
        """The anomaly guard's host bookkeeping after a guarded step: an
        anomalous step's counters and run length, or a clean step's
        gradient-norm EMA."""
        stats, t = self.robustness, self.cfg.train
        if m["anomaly"] > 0:
            stats.anomalous_steps += 1
            stats.nonfinite_steps += int(m["nonfinite"] > 0)
            stats.spike_steps += int(m["spike"] > 0)
            self._anomaly_run += 1
            log.warning(
                "anomalous step %d skipped (%s; grad_norm %.3g; run %d/%d)",
                step, "non-finite" if m["nonfinite"] > 0 else "norm spike",
                m["grad_norm"], self._anomaly_run, t.anomaly_limit,
            )
        else:
            self._anomaly_run = 0
            beta = t.anomaly_ema_beta
            g = m["grad_norm"]
            self._gnorm_ema = (g if self._gnorm_ema is None
                               else beta * self._gnorm_ema + (1 - beta) * g)

    def _poison_variant(self):
        """The FaultInjector "nan" step, built on first use."""
        if self._poison_step is None:
            self._poison_step = make_train_step(self.cfg, self._schedule, poison=True,
                                                mesh=self.mesh)
        return self._poison_step

    def _rollback(self, failed_step: int) -> tuple[TrainState, int]:
        """Auto-rollback after train.anomaly_limit consecutive anomalies:
        restore the newest intact checkpoint and fast-forward the data
        cursor past the poisoned batch window, so the replayed optimizer
        steps draw fresh batches instead of the poison. Idempotent under
        repetition — every episode skips further."""
        stats = self.robustness
        stats.rollbacks += 1
        stats.last_fault_reason = (
            f"anomaly_rollback: {self._anomaly_run} consecutive anomalous "
            f"steps ending at step {failed_step}"
        )
        # The postmortem before the restore moves the loader and EMA state:
        # the dump holds the poisoned window as the rollback saw it.
        self._flight_dump("anomaly_rollback", failed_step=failed_step,
                          anomaly_run=self._anomaly_run)
        if self.ckpt is None:
            raise RollbackFailed(
                f"{self._anomaly_run} consecutive anomalous steps at step "
                f"{failed_step} and no checkpoint.directory to roll back to"
            )
        restored = self.ckpt.restore_latest(abstract_train_state(self.cfg))
        stats.corrupt_checkpoints += len(self.ckpt.quarantined)
        if restored is None:
            raise RollbackFailed(
                f"{self._anomaly_run} consecutive anomalous steps at step "
                f"{failed_step} and no intact checkpoint to roll back to"
            )
        tree, good_step = restored
        extra = self.ckpt.last_restore_extra or {}
        loader_state = dict(extra.get("loader") or {})
        # Defensive clamp: if the newest intact checkpoint is AHEAD of the
        # failed step, replay starts past the poison already — never ask
        # the cursor to rewind.
        skip = max((failed_step + 1) - good_step, 0)
        self.loader.load_state_dict(loader_state)
        self.loader.skip_batches(skip)
        stats.skipped_batches += skip
        self._gnorm_ema = extra.get("gnorm_ema")
        self._anomaly_run = 0
        # Persist the advanced cursor AT the restored step at once: a crash
        # before the next periodic save would otherwise resume with the old
        # cursor, replay the poison, and roll back again.
        self.ckpt.save(good_step, tree, force=True, overwrite=True,
                       extra=self._ckpt_extra())
        log.warning(
            "auto-rollback: restored step %d, skipping the %d-batch poison "
            "window (data cursor offset now %d)",
            good_step, skip, self.loader.offset,
        )
        return state_from_tree(tree, self.cfg.model, self.device), good_step

    def _overwrite_from(self) -> int:
        """Newest committed step at rollback time: checkpoints after the
        restored step captured the abandoned trajectory and are overwritten
        as the replay passes them."""
        if self.ckpt is None:
            return -1
        latest = self.ckpt.latest_step()
        return latest if latest is not None else -1

    # -- data -------------------------------------------------------------

    def global_batch(self, step: int) -> dict[str, torch.Tensor]:
        """The step's batch on the device, with the grad_accum microbatch
        axis leading when accumulating: [A, b, S]. Under sequence
        parallelism, this rank's contiguous slice of the sequence axis of
        every leaf (targets shifted before slicing), with the slice's
        global positions where the batch has none."""
        host = dict(self.loader.batch_at(step))
        sp = self.cfg.parallel.sp
        if sp > 1:
            S = host["inputs"].shape[-1]
            if "positions" not in host:
                host["positions"] = np.broadcast_to(
                    np.arange(S, dtype=np.int32), host["inputs"].shape)
            lo, hi = self.sp_rank * S // sp, (self.sp_rank + 1) * S // sp
            host = {k: v[..., lo:hi] for k, v in host.items()}
        accum = self.cfg.train.grad_accum
        if accum > 1:
            host = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
                    for k, v in host.items()}
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in host.items()}

    # -- loop -------------------------------------------------------------

    def fit(
        self,
        state: Optional[TrainState] = None,
        preemption_handler: Optional[Any] = None,
        restart_info: Optional[tuple] = None,
    ) -> list:
        """Run steps from ``state`` (default: ``restore_or_init()``) up to
        ``train.num_steps``; returns the metrics history.

        ``restart_info=(attempt, reason)`` threads the supervisor context
        (``run_with_restarts``) into the step log: the restart count rides
        the metrics extras, the previous attempt's fault reason the log
        line. ``preemption_handler`` replaces the SIGTERM handler the loop
        installs for itself.
        """
        cfg = self.cfg
        stats = self.robustness
        if restart_info is not None:
            attempt, reason = restart_info
            stats.restarts = int(attempt)
            if reason:
                stats.last_fault_reason = str(reason)
            if attempt:
                log.warning("supervisor restart %d: resuming after %s",
                            attempt, reason or "unknown fault")
        if state is None:
            state, _ = self.restore_or_init()
        guard = cfg.train.anomaly_guard
        injector = self.fault_injector
        profile = cfg.train.profile_steps if self._lead else None
        prof = None                 # the live profile_steps capture
        tracer = self._tracer
        watch = metrics_lib.Stopwatch()
        # After an auto-rollback the replayed trajectory differs from the
        # one the existing checkpoints captured; overwrite them up to the
        # rollback point so a crash mid-replay resumes the NEW trajectory.
        overwrite_until = -1
        # True while a step may be writing the state in place: an interrupt
        # there leaves no consistent state to save.
        mid_step = False
        try:
            with contextlib.ExitStack() as stack:
                preempt = (preemption_handler if preemption_handler is not None
                           else stack.enter_context(PreemptionHandler()))
                # Disabled no-op when watchdog_timeout_s is None.
                watchdog = stack.enter_context(
                    Watchdog(cfg.train.watchdog_timeout_s, action=cfg.train.watchdog_action))
                step = state["step"]
                while step < cfg.train.num_steps:
                    if cfg.train.inject_fault_at_step == step:
                        key = (cfg.checkpoint.directory, step)
                        if key not in _FIRED_FAULTS:
                            _FIRED_FAULTS.add(key)
                            raise FaultInjected(f"injected fault at step {step}")
                    if injector is not None and injector.take("dispatch", step, "train"):
                        raise InjectedFault(f"injected train dispatch fault at step {step}")
                    if profile and step == profile[0]:
                        prof = self._start_profile()
                    s0 = time.monotonic() if tracer.enabled else 0.0
                    with tracer.span("data", step=step):
                        batch = self.global_batch(step)
                    step_fn = self.train_step
                    if injector is not None and injector.take("nan", step, "train") is not None:
                        log.warning("fault injection: NaN-poisoned train step %d", step)
                        step_fn = self._poison_variant()
                    mid_step = True
                    # The train#<step> range marks the step in a profiler
                    # capture over the same window; the dispatch span covers
                    # the step through its metric fetch.
                    with tracer.step_annotation("train", step), tracer.span("dispatch", step=step):
                        if guard:
                            state, m = step_fn(state, batch, self._spike_limit())
                        else:
                            state, m = step_fn(state, batch)
                    mid_step = False
                    dt = watch.lap(sync_on=self.device)
                    watchdog.heartbeat()
                    extras = {"ce_loss": m["ce_loss"], "moe_aux": m["moe_aux"]}
                    anomalous = bool(guard and m["anomaly"] > 0)
                    if guard:
                        with tracer.span("guard", step=step):
                            extras["anomaly"] = m["anomaly"]
                            self._guard_update(step, m)
                    if stats.restarts or stats.rollbacks or stats.anomalous_steps:
                        extras.update(stats.as_extras())
                    self.metrics.record(
                        step=step + 1,
                        loss=m["loss"],
                        tokens=self.tokens_per_step,
                        step_time_s=dt,
                        grad_norm=m["grad_norm"],
                        learning_rate=m["lr"],
                        **extras,
                    )
                    if prof is not None and step + 1 >= profile[1]:
                        self._stop_profile(prof)
                        prof = None
                        watch.lap()   # the trace's export out of the next step's time
                    if (step + 1) % max(cfg.train.log_interval, 1) == 0:
                        self._export_prom()
                    if anomalous and self._anomaly_run >= cfg.train.anomaly_limit:
                        if tracer.enabled:
                            # The anomalous step's span closes before the
                            # rollback's `continue`: the step a postmortem
                            # inspects is no hole in the timeline.
                            tracer.record_span("train_step", s0, time.monotonic(), step=step,
                                               anomalous=True)
                        state, step = self._rollback(step)
                        overwrite_until = self._overwrite_from()
                        watch.lap()   # rollback time out of the next step's MFU
                        continue
                    if self.ckpt is not None:
                        # Async saves enqueue here (the host snapshot), sync
                        # saves block: either cost lands in this span.
                        with tracer.span("ckpt", step=step):
                            self._save(step + 1, state, overwrite=step + 1 <= overwrite_until)
                    if tracer.enabled:
                        tracer.record_span("train_step", s0, time.monotonic(), step=step,
                                           anomalous=anomalous)
                    if preempt.preempted:
                        # Step boundary: the state is consistent. Persist and
                        # stop cleanly; a supervisor restart resumes
                        # losslessly. The emergency save queues BEHIND any
                        # in-flight async save and wait() drains both.
                        if self.ckpt is not None and cfg.train.emergency_ckpt:
                            if self._save(step + 1, state, force=True,
                                          overwrite=step + 1 <= overwrite_until):
                                stats.emergency_saves += 1
                            self.ckpt.wait()
                        raise Preempted(f"preempted after step {step + 1}")
                    step += 1
                if self.ckpt is not None:
                    self._save(cfg.train.num_steps, state, force=True)
            self.state = state
            return self.metrics.history
        except (KeyboardInterrupt, FaultInjected, InjectedFault):
            # Preemption-safe path: persist the newest complete state, then
            # re-raise so a supervisor can restart and restore_or_init. An
            # interrupt inside a step may have left the state half-updated
            # in place: then the last periodic checkpoint stands.
            if self.ckpt is not None and cfg.train.emergency_ckpt:
                if mid_step:
                    log.warning("interrupted mid-step; relying on the last "
                                "periodic checkpoint")
                else:
                    at_step = state["step"]
                    # Inside a rollback-replay window the committed
                    # checkpoint at this step captured the ABANDONED
                    # trajectory; the emergency save must replace it.
                    if self._save(at_step, state, force=True,
                                  overwrite=at_step <= overwrite_until):
                        stats.emergency_saves += 1
                self.ckpt.wait()
            raise
        finally:
            if prof is not None:
                self._stop_profile(prof)
            if self.ckpt is not None:
                self.ckpt.wait()
            self.metrics.close()
            export_chrome_safe(tracer, cfg.train.trace_path)
            self._export_prom()
