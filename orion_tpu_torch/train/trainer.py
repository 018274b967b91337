"""The training step loop on one GPU.

Counterpart of ``orion_tpu/train/trainer.py`` (``Trainer.fit`` ->
``make_train_step`` -> ``models.transformer.loss_fn``) for a single
device: float32 master parameters (``model.param_dtype``), compute in
``model.dtype`` (weights cast at use), autograd through the port's ops —
on the card RMSNorm (K1/K5), RoPE (K2/K6) and flash attention (K3/K7/K8)
run their hand-written kernels — then clipping and the AdamW update in
place. Gradient accumulation splits the global batch into
``train.grad_accum`` microbatches; ``train.grad_dtype`` takes the
gradients with respect to a parameter copy in that dtype.

Not ported yet, and rejected at construction (``_check_supported``):
checkpointing, the anomaly guard and rollback, ZeRO-1 and quantized
gradient collectives, evaluation, profiling windows, tracing/flight
recorder/Prometheus export, fault injection and supervisor restarts,
every parallel axis > 1 and more than one process
(``runtime.num_processes``), MoE, weight quantization, checkify, debug
asserts, ``runtime.debug_nans`` and ``runtime.deterministic``, and remat
policies other than none/full.

The trainer runs on ``cuda`` unless the caller passes ``device="cpu"``
(the plain PyTorch versions of the kernels); with no device given and no
GPU present it raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from orion_tpu_torch import metrics as metrics_lib
from orion_tpu_torch.config import Config, ModelConfig
from orion_tpu_torch.data import make_loader
from orion_tpu_torch.infer.engine import resolve_device
from orion_tpu_torch.models.convert import (
    init_params,
    to_device,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from orion_tpu_torch.models.transformer import loss_fn, torch_dtype
from orion_tpu_torch.train.optimizer import apply_updates, init_opt_state, make_schedule

TrainState = dict[str, Any]


def _check_supported(cfg: Config) -> None:
    m, t, c, r = cfg.model, cfg.train, cfg.checkpoint, cfg.runtime
    remat = t.remat if t.remat != "inherit" else m.remat
    unsupported = {
        "checkpoint.directory": c.directory is not None,
        "train.anomaly_guard": t.anomaly_guard,
        "train.zero1": t.zero1,
        "train.zero1_quantize": t.zero1_quantize is not None,
        "train.grad_quant_bits": t.grad_quant_bits is not None,
        "train.eval_interval": t.eval_interval is not None,
        "train.profile_steps": t.profile_steps is not None,
        "train.inject_fault_at_step": t.inject_fault_at_step is not None,
        "train.max_restarts > 0": t.max_restarts > 0,
        "train.watchdog_timeout_s": t.watchdog_timeout_s is not None,
        "train.trace / trace_path / flight_dir / metrics_prom": (
            t.trace or t.trace_path is not None or t.flight_dir is not None
            or t.metrics_prom is not None
        ),
        f"remat={remat!r} (none|full are ported)": remat not in ("none", "full"),
        "remat_offload": t.remat_offload or m.remat_offload,
        "parallel axes > 1": cfg.parallel.num_devices > 1,
        "model.n_experts > 0 (MoE)": m.is_moe,
        "model.weight_quant": m.weight_quant is not None,
        "runtime.checkify": r.checkify,
        "runtime.debug_nans": r.debug_nans,
        "runtime.deterministic": r.deterministic,
        "runtime.num_processes > 1 (multi-process training)": r.num_processes > 1,
        "model.debug_asserts": m.debug_asserts,
    }
    bad = [name for name, on in unsupported.items() if on]
    if bad:
        raise NotImplementedError(
            f"not ported to orion_tpu_torch yet: {', '.join(bad)}"
        )


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
) -> tuple[torch.Tensor, dict[str, torch.Tensor], Any]:
    """(loss, aux, grads) of ``loss_fn``; ``grads`` is a tree like
    ``params``. With ``accum`` > 1 the batch leaves are [accum, b, S]
    microbatches: grads and loss are means over them (float32
    accumulators), token counts sum. With ``grad_dtype`` the gradients
    are taken with respect to a copy of the parameters in that dtype."""

    def value_and_grad(mb):
        leaves = [
            p.detach().to(torch_dtype(grad_dtype) if grad_dtype else p.dtype)
            .requires_grad_(True)
            for p in tree_leaves(params)
        ]
        loss, aux = loss_fn(tree_unflatten(params, leaves), mb, mcfg)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, list(grads)

    if accum == 1:
        loss, aux, grads = value_and_grad(batch)
        return loss, aux, tree_unflatten(params, grads)
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
    return loss_sum * inv, aux, tree_unflatten(params, acc)


def make_train_step(
    cfg: Config, schedule: Callable[[int], float]
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """The per-step function: forward + backward (+ accumulation), clip
    and AdamW/SGD update in place. Returns (state, step metrics)."""
    accum, gdt = cfg.train.grad_accum, cfg.train.grad_dtype

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        lr = schedule(state["opt"]["count"])
        loss, aux, grads = loss_and_grads(state["params"], batch, cfg.model, accum, gdt)
        _, _, opt_metrics = apply_updates(
            state["params"], grads, state["opt"], cfg.optimizer, lr)
        state["step"] += 1
        return state, {
            "loss": loss,
            "ce_loss": aux["ce_loss"],
            "moe_aux": aux["moe_aux"],
            "grad_norm": opt_metrics["grad_norm"],
            "lr": lr,
        }

    return train_step


class Trainer:
    """Builds the loader, the state and the step, and runs the fit loop.

    ``params`` (a parameter tree, e.g. ``models.from_jax_params`` of the
    JAX package's init) replaces the seeded random init; ``device`` is a
    torch device (default ``cuda``)."""

    def __init__(self, cfg: Config, params: Optional[Any] = None, device=None):
        if cfg.train.remat != "inherit":
            # train.remat is the training-side spelling of model.remat.
            cfg = dataclasses.replace(
                cfg, model=dataclasses.replace(cfg.model, remat=cfg.train.remat))
        _check_supported(cfg)
        accum = max(cfg.train.grad_accum, 1)
        if cfg.data.batch_size % accum:
            raise ValueError(
                f"grad_accum={cfg.train.grad_accum} must divide global batch "
                f"{cfg.data.batch_size}"
            )
        self.cfg = cfg
        self.device = resolve_device(device)
        self._params = params
        self.loader = make_loader(cfg.data, cfg.model.vocab_size)
        self.train_step = make_train_step(
            cfg, make_schedule(cfg.optimizer, cfg.train.num_steps))
        # data.batch_size is the global batch per optimizer step; grad_accum
        # only splits it into microbatches.
        self.tokens_per_step = cfg.data.batch_size * cfg.data.seq_len
        peak = cfg.train.peak_flops_per_device or metrics_lib.peak_flops_per_device(
            self.device)
        self.metrics = metrics_lib.MetricsLogger(
            flops_per_token=cfg.model.flops_per_token(cfg.data.seq_len),
            num_devices=1,
            peak_flops=peak,
            jsonl_path=cfg.train.metrics_jsonl,
            log_interval=cfg.train.log_interval,
        )

    def init_state(self) -> TrainState:
        return init_train_state(self.cfg, self.device, self._params)

    def global_batch(self, step: int) -> dict[str, torch.Tensor]:
        """The step's batch on the device, with the grad_accum microbatch
        axis leading when accumulating: [A, b, S]."""
        host = dict(self.loader.batch_at(step))
        accum = self.cfg.train.grad_accum
        if accum > 1:
            host = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
                    for k, v in host.items()}
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in host.items()}

    def fit(self, state: Optional[TrainState] = None) -> list:
        """Run steps from ``state`` (default: a fresh ``init_state()``) up
        to ``train.num_steps``; returns the metrics history."""
        cfg = self.cfg
        if state is None:
            state = self.init_state()
        watch = metrics_lib.Stopwatch()
        try:
            while state["step"] < cfg.train.num_steps:
                step = state["step"]
                batch = self.global_batch(step)
                state, m = self.train_step(state, batch)
                dt = watch.lap(sync_on=self.device)
                self.metrics.record(
                    step=step + 1,
                    loss=float(m["loss"]),
                    tokens=self.tokens_per_step,
                    step_time_s=dt,
                    grad_norm=float(m["grad_norm"]),
                    learning_rate=m["lr"],
                    ce_loss=float(m["ce_loss"]),
                    moe_aux=float(m["moe_aux"]),
                )
            self.state = state
            return self.metrics.history
        finally:
            self.metrics.close()
