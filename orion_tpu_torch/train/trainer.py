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

Parallelism over a mesh of GPUs, one process a device (``torchrun
--nproc_per_node=<mesh size>``, or ``runtime.coordinator_address`` /
``num_processes`` / ``process_id``), joined by
``runtime.distributed.initialize`` (NCCL on the card, gloo on the CPU)
into a ``runtime.mesh`` mesh of ``parallel.dp`` x ``parallel.fsdp`` x
``parallel.sp`` ranks (``parallel/data_parallel.py`` holds the mesh's
side of the step):

- data parallelism (``dp``) and FSDP (``fsdp``): every rank reads the same
  global batch and keeps its rows (over dp x fsdp, in the JAX device
  order); FSDP holds each leaf with an ``embed`` dimension as the rank's
  1/fsdp block, gathered where it is used (inside each block; the
  gather's transpose reduce-scatters its gradient); the other gradients
  are all-reduced over the axes that hold them whole;
- ZeRO-1 (``train.zero1``, dp > 1): the gradients reduce-scatter over
  ``dp`` onto each leaf's update dimension, AdamW updates the rank's
  1/dp block of the moments (and of the float32 ``opt["master"]`` where
  ``model.param_dtype`` != ``model.dtype``), and the updated blocks are
  all-gathered back; the state equals the plain dp run's bit for bit
  (under the master split, the dp run whose gradients are taken against
  the same copy, ``train.grad_dtype``);
- sequence parallelism (``sp``, as the JAX trainer routes it,
  ``orion_tpu/train/trainer.py:672-711``): each rank keeps its contiguous
  sequence slice of the inputs, targets, loss mask, segment ids and
  positions (global positions where the batch has none); attention runs
  as ``parallel.sequence_attention`` with ``parallel.sequence_method``.

The loss is the global token mean (the count summed over the mesh; each
rank backpropagates its share), so every rank applies the same update.
Checkpoints save each rank's blocks with their global indices (process 0
writes the replicated leaves and merges the manifest) and restore at any
layout; the anomaly guard's skip is a vote of every rank, the preemption
flag rides the step's loss reduction, and rollbacks, emergency saves and
restarts move every rank together. A
``FaultInjector`` schedule must be the same on every rank, except the
"nan" kind, whose poisoned loss reaches every rank through the reduction.
Logs, the metrics file, the tracer, flight dumps, ``metrics_prom`` and the
profiler window come from rank 0 of the mesh.

Observability (``orion_tpu_torch/obs``, the JAX trainer's wiring): a
metrics registry (sections robust, train: the newest step's metrics, and
hbm); with ``train.trace``, ``trace_path`` or ``flight_dir`` the spans
``data``, ``dispatch`` (inside a ``train#<step>`` profiler range),
``guard``, ``ckpt`` and ``train_step`` per step, exported as a Chrome trace
to ``trace_path`` when ``fit`` ends; with ``flight_dir`` a postmortem at an
anomaly rollback; ``metrics_prom`` every ``log_interval`` steps and at the
end; ``profile_steps=(a, b)`` a ``torch.profiler`` capture of steps a to
b - 1 (CPU activity, and CUDA activity on the card), its Chrome trace
written under ``profile_dir``. On a mesh these act on rank 0 only.

Remat (``model.remat`` / ``train.remat``: none, full, dots, names, and
names with ``remat_offload``; ``models/remat.py``), the sanitizers
(``runtime.checkify``: batch indices and the loss's and gradients'
finiteness checked before the update; ``runtime.debug_nans``: NaN checks
forward and backward; ``runtime.deterministic``; ``model.debug_asserts``:
routing and ring-position asserts, ``runtime/asserts.py``), held-out
evaluation (``train.eval_interval``, ``evaluate``) and ``memory_report``
are the JAX trainer's.

Not ported yet, and rejected at construction (``_check_supported``): the
quantized gradient collectives (``train.grad_quant_bits``,
``train.zero1_quantize``), tensor, pipeline and expert parallelism
(``runtime.mesh.check_axes`` names the mode; the serving engine runs
tensor parallelism, the trainer not yet), MoE on a mesh, and
``model.scan_group`` > 1 (the JAX package's grouped remat boundary, a
memory trade; the JAX trainer's ValueErrors for an indivisible scan unit
come first).

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
from orion_tpu_torch.ckpt.checkpoint import CheckpointShards
from orion_tpu_torch.config import Config, ModelConfig
from orion_tpu_torch.data import make_loader
from orion_tpu_torch.infer.engine import resolve_device
from orion_tpu_torch.models.convert import (
    init_params,
    jax_leaves_with_path,
    stack_layers,
    to_device,
    tree_leaves,
    tree_leaves_with_path,
    tree_map,
    tree_unflatten,
    unstack_layers,
)
from orion_tpu_torch.models.remat import RematLog, remat_policy
from orion_tpu_torch.models.transformer import loss_fn, torch_dtype
from orion_tpu_torch.parallel.data_parallel import DataParallel
from orion_tpu_torch.parallel.sharding import layout_at
from orion_tpu_torch.obs import MetricsRegistry, export_chrome_safe, init_obs, live_hbm_metrics
from orion_tpu_torch.runtime import sanitize
from orion_tpu_torch.runtime.asserts import raise_if_failed
from orion_tpu_torch.runtime.distributed import apply_flags, initialize, process_index
from orion_tpu_torch.runtime.mesh import build_mesh, check_axes, check_dcn_axes
from orion_tpu_torch.runtime.fault import (
    TRAIN_KINDS,
    InjectedFault,
    Preempted,
    PreemptionHandler,
    Watchdog,
)
from orion_tpu_torch.train.optimizer import (
    Zero1Plan,
    apply_updates,
    global_norm,
    init_opt_state,
    make_schedule,
    tree_all_finite,
    zero1_master_split,
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
    """The JAX trainer's own ValueErrors first (its messages), then the
    NotImplementedError of every part the port does not run yet."""
    m, t, r, p = cfg.model, cfg.train, cfg.runtime, cfg.parallel
    if m.weight_quant is not None:
        raise ValueError(
            "model.weight_quant is a serving-only knob (the engine "
            "quantizes at init); training runs full-precision masters"
        )
    if t.zero1:
        if p.dp < 2:
            raise ValueError(
                "train.zero1 needs parallel.dp > 1: the optimizer "
                "state shards 1/dp across the dp axis"
            )
        if t.grad_quant_bits:
            raise ValueError(
                "train.zero1 replaces the dp gradient all-reduce with "
                "a reduce-scatter, so train.grad_quant_bits has no "
                "collective left to quantize; use train.zero1_quantize"
            )
        if t.zero1_quantize:
            if p.pp > 1:
                raise ValueError(
                    "train.zero1_quantize is rejected under "
                    "parallel.pp: the int8 wire legs run manual "
                    "over dp and cannot nest inside the pipeline's "
                    "pp shard_map; use full-precision train.zero1 "
                    "(composes with pp) or drop pp"
                )
            others = {k: v for k, v in p.axis_sizes.items() if k != "dp" and v > 1}
            if others:
                raise ValueError(
                    f"train.zero1_quantize needs pure DP (the wire "
                    f"legs run manual over dp); mesh has {others}"
                )
    elif t.zero1_quantize:
        raise ValueError(
            "train.zero1_quantize without train.zero1 has no "
            "ZeRO-1 collective legs to quantize"
        )
    if m.scan_layers and m.n_layers % m.scan_unit:
        raise ValueError(
            f"model.n_layers={m.n_layers} must be divisible by "
            f"the layer-scan unit {m.scan_unit} "
            f"(model.scan_group={m.scan_group}"
            + (f" x pattern={m.window_pattern}" if m.window_pattern else "") + ")"
        )
    if m.scan_group > 1 and not m.scan_layers:
        raise ValueError(
            "model.scan_group > 1 requires model.scan_layers=true "
            "(grouping is a property of the layer scan)"
        )
    check_dcn_axes(p)
    if r.num_processes > 1 and r.num_processes != p.num_devices:
        raise ValueError(
            f"runtime.num_processes={r.num_processes} must equal the mesh size "
            f"{p.num_devices} ({dict(p.axis_sizes)}): the port runs one process a device")
    unsupported = {
        "train.zero1_quantize (the int8 ZeRO-1 wire legs)": t.zero1_quantize is not None,
        "train.grad_quant_bits (the int8 gradient all-reduce)": t.grad_quant_bits is not None,
        "model.n_experts > 0 (MoE) with parallel.dp, fsdp or sp > 1 (comes with "
        "expert parallelism)": m.is_moe and p.num_devices > 1,
        "model.scan_group > 1 (the remat boundary grouped over scan_group "
        "layers)": m.scan_group > 1,
    }
    bad = [name for name, on in unsupported.items() if on]
    if bad:
        raise NotImplementedError(
            f"not ported to orion_tpu_torch yet: {', '.join(bad)}"
        )
    check_axes(p)


def _check_checkify(cfg: Config) -> None:
    """The JAX trainer's refusals of ``runtime.checkify``: beside the
    anomaly guard, and where its step runs manual shard_map regions (here
    the sequence-parallel collectives)."""
    if not cfg.runtime.checkify:
        return
    if cfg.train.anomaly_guard:
        raise ValueError(
            "train.anomaly_guard handles non-finite steps by skipping "
            "them in-program; runtime.checkify raises host-side on the "
            "same condition — pick one"
        )
    if cfg.parallel.sp > 1:
        raise ValueError(
            "runtime.checkify does not compose with manual shard_map regions "
            "(parallel.sp>1 (ring/Ulysses shard_map)); use runtime.debug_nans, "
            "or check the step on an SPMD-automatic layout (dp/fsdp/tp/ep-sorted)"
        )


def fold_train_remat(cfg: Config) -> Config:
    """``train.remat`` / ``train.remat_offload`` folded into the model config
    as the JAX trainer folds them: an explicit ``train.remat`` replaces
    ``model.remat`` (None, the override parser's "none", turns remat off);
    an explicit policy other than names drops ``model.remat_offload``, any
    other case ORs the two offload flags."""
    t, m = cfg.train, cfg.model
    if t.remat == "inherit" and not t.remat_offload:
        return cfg
    explicit = t.remat != "inherit"
    drop_model_offload = explicit and t.remat != "names"
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, remat=t.remat if explicit else m.remat,
        remat_offload=(t.remat_offload if drop_model_offload
                       else t.remat_offload or m.remat_offload)))


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


def _check_injector(injector) -> None:
    """Refuse a fault schedule holding kinds training does not consume."""
    if injector is None:
        return
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
    hold: params and moments (and ZeRO-1's ``master``) with their blocks
    stacked (``scan_layers``), ``opt.count`` and ``step`` as 0-d int32
    tensors. On a mesh the leaves are the rank's blocks."""
    opt = state["opt"]
    out_opt = {
        "count": torch.tensor(opt["count"], dtype=torch.int32),
        "mu": stack_layers(opt["mu"], mcfg),
        "nu": stack_layers(opt["nu"], mcfg),
    }
    if "master" in opt:
        out_opt["master"] = stack_layers(opt["master"], mcfg)
    return {
        "params": stack_layers(state["params"], mcfg),
        "opt": out_opt,
        "step": torch.tensor(state["step"], dtype=torch.int32),
    }


def state_from_tree(tree: dict, mcfg: ModelConfig, device) -> TrainState:
    """The inverse of ``state_to_tree``, on ``device`` (each leaf moved
    there before the layers are split)."""
    opt = tree["opt"]

    def layers(t):
        return unstack_layers(to_device(t, device), mcfg)

    out_opt = {"mu": layers(opt["mu"]), "nu": layers(opt["nu"]), "count": int(opt["count"])}
    if "master" in opt:
        out_opt["master"] = layers(opt["master"])
    return {"params": layers(tree["params"]), "opt": out_opt, "step": int(tree["step"])}


def abstract_train_state(cfg: Config) -> dict:
    """The checkpoint tree of a train state on the ``meta`` device: the
    whole shapes and dtypes a restore validates against, with no memory.
    Under ZeRO-1's master split the params are in ``model.dtype`` and
    ``opt.master`` in ``model.param_dtype``, as the JAX trainer's."""
    params = init_params(cfg.model, torch.Generator(), device="meta",
                         dtype=torch_dtype(cfg.model.param_dtype))
    split = zero1_master_split(cfg)
    opt = init_opt_state(params, cfg.optimizer, master=split)
    if split:
        params = to_device(params, "meta", cfg.model.dtype)
    return state_to_tree({"params": params, "opt": opt, "step": 0}, cfg.model)


def init_train_state(
    cfg: Config, device, params: Optional[Any] = None, dp: Optional[DataParallel] = None
) -> TrainState:
    """Params in ``model.param_dtype`` on ``device`` (a seeded random init
    from ``train.seed``, or a copy of ``params``), fresh optimizer state
    and step 0. On a data-parallel mesh (``dp``) the rank keeps its blocks
    (``DataParallel.shard``); under ZeRO-1 the moments (and the master
    split's ``opt.master``) are its 1/dp blocks, and the split's params the
    working copy in ``model.dtype``."""
    pdt = torch_dtype(cfg.model.param_dtype)
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(cfg.train.seed)
        params = init_params(cfg.model, gen, device=device, dtype=pdt)
    else:
        params = tree_map(lambda t: t.to(device=device, dtype=pdt, copy=True), params)
    if dp is not None and dp.rows > 1:
        params = dp.shard(params)
    split = zero1_master_split(cfg)
    opt = init_opt_state(params, cfg.optimizer, master=split,
                         zero1=zero1_plan(dp, params) if cfg.train.zero1 else None)
    if split:
        params = to_device(params, device, cfg.model.dtype)
    return {"params": params, "opt": opt, "step": 0}


def zero1_plan(dp: DataParallel, params: Any) -> Zero1Plan:
    """The ZeRO-1 plan of ``params``' leaves (``tree_leaves`` order)."""
    return Zero1Plan(group=dp.group("dp"), n=dp.dp, index=dp.coords["dp"],
                     dims=tuple(layout_at(dp.layout, path).zero1_dim
                                for path, _ in tree_leaves_with_path(params)))


def loss_and_grads(
    params: Any,
    batch: dict[str, torch.Tensor],
    mcfg: ModelConfig,
    accum: int = 1,
    grad_dtype: Optional[str] = None,
    poison: bool = False,
    dp: Optional[DataParallel] = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor], Any]:
    """(loss, aux, grads) of ``loss_fn``; ``grads`` is a tree like
    ``params``. With ``accum`` > 1 the batch leaves are [accum, b, S]
    microbatches: grads and loss are means over them (float32
    accumulators), token counts sum. With ``grad_dtype`` the gradients
    are taken with respect to a copy of the parameters in that dtype.
    ``poison`` multiplies the loss by NaN inside the differentiated
    function, so NaNs flow through the real backward into every gradient
    (the fault injector's "nan" kind). On a mesh (``dp``, a
    ``DataParallel``) ``batch`` is this rank's share and ``params`` its
    blocks; the loss and its aux terms come back summed over the mesh (the
    global values, the same on every rank) and the gradients reduced
    (``DataParallel.reduce``: this rank's blocks, under ZeRO-1 its dp
    blocks). Under ``runtime.debug_nans`` the forward and the backward run
    under its NaN checks (``runtime/sanitize.py``)."""
    mesh = None if dp is None else dp.mesh
    gather = None if dp is None else dp.gather

    def value_and_grad(mb):
        leaves = [
            p.detach().to(torch_dtype(grad_dtype) if grad_dtype else p.dtype)
            .requires_grad_(True)
            for p in tree_leaves(params)
        ]
        with sanitize.nan_forward():
            loss, aux = loss_fn(tree_unflatten(params, leaves), mb, mcfg, mesh, gather=gather)
            if poison:
                loss = loss * torch.tensor(float("nan"), dtype=loss.dtype,
                                           device=loss.device)
        with sanitize.nan_backward():
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, list(grads)

    if accum == 1:
        loss, aux, grads = value_and_grad(batch)
    else:
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
        loss, grads = loss_sum * inv, acc
        aux = {k: v if k == "tokens" else v * inv for k, v in aux_sum.items()}
    if dp is None:
        return loss, aux, tree_unflatten(params, grads)
    return dp.reduce(loss, aux, grads, params)


def make_train_step(
    cfg: Config, schedule: Callable[[int], float], poison: bool = False,
    dp: Optional[DataParallel] = None,
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
    (``loss_and_grads(poison=True)``). ``dp`` is the mesh
    (``DataParallel``; the batch then this rank's share): the clip norm
    is taken over the mesh, the finiteness is a vote of every rank, and
    under ZeRO-1 the update runs on the rank's blocks.

    With ``runtime.checkify`` the step is checked (``runtime/sanitize.py``):
    the batch's tokens and targets within the vocabulary before the
    forward, the loss and every gradient finite before the update; a
    failed check raises ``CheckifyError`` with the state untouched, on
    every rank of a mesh.
    """
    accum, gdt = cfg.train.grad_accum, cfg.train.grad_dtype
    checked = cfg.runtime.checkify
    meshed = dp is not None and dp.rows > 1

    def check(fn, *args):
        """A sanitizer check, on a mesh voted over every rank."""
        if dp is None:
            return fn(*args)
        err = None
        try:
            fn(*args)
        except sanitize.CheckifyError as e:
            err = e
        if not bool(dp.all_ranks(torch.tensor(err is None))):
            raise err or sanitize.CheckifyError("a check failed on another rank: "
                                                "the step was not applied")

    def grads_of(state: TrainState, batch: dict):
        lr = schedule(state["opt"]["count"])
        if checked:
            check(sanitize.check_indices, batch, cfg.model.vocab_size)
        loss, aux, grads = loss_and_grads(state["params"], batch, cfg.model, accum, gdt,
                                          poison=poison, dp=dp)
        if checked:
            check(sanitize.check_finite, loss, tree_leaves(grads))
        return lr, loss, aux, grads

    def norm_of(grads):
        return dp.global_norm(grads) if meshed else global_norm(grads)

    def update(state: TrainState, grads, lr, gnorm=None):
        """apply_updates on the state (the mesh's norm; ZeRO-1's plan)."""
        kw = {} if gnorm is None else {"gnorm": gnorm}
        if cfg.train.zero1:
            kw["zero1"] = zero1_plan(dp, state["params"])
        return apply_updates(state["params"], grads, state["opt"], cfg.optimizer, lr, **kw)

    def fetch(*scalars: torch.Tensor) -> list[float]:
        """The step's one device-to-host copy."""
        return torch.stack([x.float() for x in scalars]).tolist()

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        lr, loss, aux, grads = grads_of(state, batch)
        _, _, opt_metrics = update(state, grads, lr, norm_of(grads) if meshed else None)
        state["step"] += 1
        loss, ce, moe, gnorm = fetch(loss, aux["ce_loss"], aux["moe_aux"],
                                     opt_metrics["grad_norm"])
        return state, {"loss": loss, "ce_loss": ce, "moe_aux": moe, "grad_norm": gnorm,
                       "lr": lr}

    if not cfg.train.anomaly_guard:
        return train_step

    def guarded_step(state: TrainState, batch: dict, norm_limit) -> tuple[TrainState, dict]:
        lr, loss, aux, grads = grads_of(state, batch)
        gnorm = norm_of(grads)
        finite = torch.isfinite(loss) & tree_all_finite(grads).to(loss.device)
        if dp is not None:
            finite = dp.all_ranks(finite)
        loss_h, ce, moe, gnorm_h, finite_h = fetch(loss, aux["ce_loss"], aux["moe_aux"],
                                                   gnorm, finite)
        finite_h = finite_h > 0
        # float32 against float32, as the JAX step compares on the device.
        spike = finite_h and gnorm_h > float(np.float32(norm_limit))
        ok = finite_h and not spike
        if ok:
            update(state, grads, lr, gnorm)
        state["step"] += 1
        return state, {
            "loss": loss_h, "ce_loss": ce, "moe_aux": moe, "grad_norm": gnorm_h, "lr": lr,
            "anomaly": float(not ok), "nonfinite": float(not finite_h),
            "spike": float(spike),
        }

    return guarded_step


def _asserted(step: Callable) -> Callable:
    """The step under ``model.debug_asserts``: failures the device asserts
    recorded surface after it (``runtime/asserts.py``)."""
    def asserted_step(*args):
        out = step(*args)
        raise_if_failed()
        return out

    return asserted_step


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
        # train.remat / remat_offload are the training-side spelling of the
        # model's; the policy is validated now, in config vocabulary.
        cfg = fold_train_remat(cfg)
        remat_policy(cfg.model)
        _check_supported(cfg)
        _check_checkify(cfg)
        _check_injector(fault_injector)
        apply_flags(cfg.runtime)
        cfg = sequence_parallel_config(cfg)
        accum = max(cfg.train.grad_accum, 1)
        if cfg.data.batch_size % accum:
            raise ValueError(
                f"grad_accum={cfg.train.grad_accum} must divide global batch "
                f"{cfg.data.batch_size}"
            )
        micro = cfg.data.batch_size // accum
        dpf = cfg.parallel.dp * cfg.parallel.fsdp
        if micro % dpf:
            raise ValueError(
                f"per-step batch {micro} (data.batch_size="
                f"{cfg.data.batch_size} / grad_accum={accum}) must be "
                f"divisible by dp*fsdp={dpf}"
            )
        self.cfg = cfg
        self.device = resolve_device(device)
        # The mesh (None on one device), this rank's place on it and the
        # trainer's data-parallel view of it.
        self.mesh, self.dp, self.sp_rank = None, None, 0
        if cfg.parallel.num_devices > 1:
            initialize(cfg.runtime, self.device)
            if self.device.type == "cuda" and self.device.index is None:
                local = int(os.environ.get("LOCAL_RANK",
                                           process_index() % torch.cuda.device_count()))
                self.device = torch.device("cuda", local)
                torch.cuda.set_device(self.device)
            self.mesh = build_mesh(cfg.parallel, self.device)
            self.sp_rank = self.mesh.get_local_rank("sp")
            self.dp = DataParallel(cfg, self.mesh)
        self.fault_injector = fault_injector
        self._params = params
        self.loader = make_loader(cfg.data, cfg.model.vocab_size)
        self._schedule = make_schedule(cfg.optimizer, cfg.train.num_steps)
        self.train_step = make_train_step(cfg, self._schedule, dp=self.dp)
        if cfg.model.debug_asserts:
            self.train_step = _asserted(self.train_step)
        self._poison_step = None
        # Held-out evaluation: its own stream (data.eval_path, eval_seed)
        # and a fixed batch set, built at the first evaluate().
        self.eval_loader = None
        self._eval_batches = None
        if cfg.train.eval_interval:
            self.eval_loader = make_loader(dataclasses.replace(
                cfg.data, path=cfg.data.eval_path or cfg.data.path,
                shuffle_seed=cfg.data.eval_seed), cfg.model.vocab_size)
        self.ckpt: Optional[CheckpointManager] = None
        if cfg.checkpoint.directory:
            self.ckpt = CheckpointManager(cfg.checkpoint.directory, cfg.checkpoint,
                                          fault_injector=fault_injector,
                                          shards=self._ckpt_shards())
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
        lead = process_index() == 0   # logs and the metrics file come from rank 0
        self.metrics = metrics_lib.MetricsLogger(
            flops_per_token=cfg.model.flops_per_token(cfg.data.seq_len),
            num_devices=cfg.parallel.num_devices,
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
        return init_train_state(self.cfg, self.device, self._params, self.dp)

    def _ckpt_shards(self) -> Optional[CheckpointShards]:
        """On a mesh, what the checkpoint manager needs to save this rank's
        blocks and read them back: the spec of every leaf of the checkpoint
        tree (``LeafLayout.ckpt_spec``; the optimizer state's under
        ``opt``), the mesh's sizes and this rank's coordinates."""
        if self.dp is None:
            return None
        specs, held = {}, {}
        scanned = self.cfg.model.scan_layers
        for path, _ in jax_leaves_with_path(abstract_train_state(self.cfg)):
            if path[0] == "params":
                inner, state = path[1:], False
            elif path[0] == "opt" and path[1] != "count":
                inner, state = path[2:], True
            else:
                specs[path] = ()     # opt.count and step: replicated scalars
                continue
            if inner[0] == "blocks" and scanned:
                inner = ("blocks", 0) + inner[1:]
            lay = layout_at(self.dp.layout, inner)
            specs[path] = lay.ckpt_spec(state=state)
            if lay.ckpt_spec(state=state, held=True) != specs[path]:
                held[path] = lay.ckpt_spec(state=state, held=True)
        return CheckpointShards(specs=specs, sizes=self.dp.sizes, coords=self.dp.coords,
                                held=held)

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

    def _preempted(self, preempt) -> bool:
        """Preempted on any rank: on a mesh the vote that the step's scalar
        reduction carried (the flags as they stood when the step began, so
        every rank takes the same branch, a step after a late signal); the
        handler's own flag on one device."""
        vote = None if self.dp is None else self.dp.preempt_vote
        return bool(preempt.preempted) if vote is None else bool(vote > 0)

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
                                                dp=self.dp)
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
        axis leading when accumulating: [A, b, S]. On a mesh, this rank's
        rows (of each microbatch) over dp x fsdp and, under sequence
        parallelism, its contiguous slice of the sequence axis of every
        leaf (targets shifted before slicing), with the slice's global
        positions where the batch has none."""
        return self._on_device(self.loader.batch_at(step), self.cfg.train.grad_accum)

    def _on_device(self, host, accum: int = 1) -> dict[str, torch.Tensor]:
        """A host batch as the step takes it (see ``global_batch``): on a
        mesh this rank's rows and sequence slice
        (``DataParallel.local_rows``)."""
        if self.dp is not None:
            host = self.dp.local_rows(host, accum)
        elif accum > 1:
            host = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
                    for k, v in host.items()}
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in host.items()}

    # -- evaluation and memory ---------------------------------------------

    @torch.no_grad()
    def evaluate(self, params: Any) -> float:
        """Mean held-out CE loss over the fixed eval batch set: batches 0 to
        ``train.eval_batches`` - 1 of the eval stream, the same every call,
        moved to the device once. On a mesh each rank's share is summed
        over the mesh."""
        assert self.eval_loader is not None, "set train.eval_interval"
        if self._eval_batches is None:
            self._eval_batches = [self._on_device(self.eval_loader.batch_at(i))
                                  for i in range(self.cfg.train.eval_batches)]
        total = 0.0
        gather = None if self.dp is None else self.dp.gather
        for batch in self._eval_batches:
            ce = loss_fn(params, batch, self.cfg.model, self.mesh, gather=gather)[1]["ce_loss"]
            if self.dp is not None:
                ce = self.dp.sum_all(ce)
            total += float(ce)
        return total / max(len(self._eval_batches), 1)

    def memory_report(self, assert_donation: bool = True) -> dict:
        """What one step holds on the device, by category, with the JAX
        report's keys: ``donated_state_bytes`` (the whole state's bytes) and
        ``donated_bytes_per_chip`` (this rank's), ``by_category``
        (``params``, ``grads`` at the gradient dtype, ``master`` (ZeRO-1's
        split, else 0: the params are the masters), ``moments``, arithmetic
        over this rank's blocks of the state; ``activations``),
        ``available``. On a mesh every rank calls it together (the step's
        collectives).

        ``activations`` are the device bytes one step's forward saves for
        the backward (one microbatch's, under grad_accum): every tensor
        autograd saves, counted once per storage through
        ``saved_tensors_hooks``, leaving out the parameters and the named
        set that ``remat_offload`` holds in host memory. The report also
        gives the remat log (``remat``: block inputs, the policy's saved
        set, the bytes moved to the host and back) and, on the card,
        ``peak_above_state_bytes``: the step's peak allocation above what
        was allocated before it.

        On a fresh ``init_state()`` the report runs one forward and
        backward on batch 0, then one ``train_step``: the update must write
        every parameter and moment in place (the counterpart of the JAX
        step's donation), and with ``assert_donation`` a leaf whose storage
        changed raises."""
        state = self.init_state()
        cfg = self.cfg
        tree = state_to_tree(state, cfg.model)
        gdt = torch_dtype(cfg.train.grad_dtype) if cfg.train.grad_dtype else None
        params = tree_leaves(state["params"])

        def nbytes(ts, dtype=None):
            return sum(t.numel() * (dtype or t.dtype).itemsize for t in ts)

        donated = nbytes(tree_leaves(tree))
        by_category = {
            "params": nbytes(params),
            "grads": nbytes(params, gdt),
            "master": nbytes(tree_leaves(state["opt"].get("master", []))),
            "moments": nbytes(tree_leaves(state["opt"]["mu"]))
            + nbytes(tree_leaves(state["opt"]["nu"])),
        }
        batch = self.global_batch(0)
        if cfg.train.grad_accum > 1:
            batch = {k: v[0] for k, v in batch.items()}
        leaves = [p.detach().to(gdt or p.dtype).requires_grad_(True) for p in params]
        own = {t.untyped_storage().data_ptr() for t in params + leaves}
        saved: dict = {}

        def pack(t):
            if t.device.type == self.device.type:
                ptr = t.untyped_storage().data_ptr()
                if ptr not in own:
                    saved[ptr] = t.untyped_storage().nbytes()
            return t

        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            base = torch.cuda.memory_allocated(self.device)
        log = RematLog()
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = loss_fn(tree_unflatten(state["params"], leaves), batch, cfg.model,
                              self.mesh, remat_log=log,
                              gather=None if self.dp is None else self.dp.gather)
        torch.autograd.grad(loss, leaves)
        del loss
        report = {
            "donated_state_bytes": nbytes(tree_leaves(abstract_train_state(cfg))),
            "donated_bytes_per_chip": donated,
            "by_category": dict(by_category, activations=sum(saved.values())),
            "available": True,
            "remat": dataclasses.asdict(log),
        }
        if cuda:
            torch.cuda.synchronize(self.device)
            report["peak_above_state_bytes"] = (
                torch.cuda.max_memory_allocated(self.device) - base)
        # The update in place: every parameter and moment keeps its storage.
        def ptrs():
            return [t.data_ptr() for t in tree_leaves(
                [state["params"], state["opt"]["mu"], state["opt"]["nu"],
                 state["opt"].get("master", [])])]

        before = ptrs()
        args = (self._spike_limit(),) if cfg.train.anomaly_guard else ()
        self.train_step(state, self.global_batch(0), *args)
        moved = sum(a != b for a, b in zip(before, ptrs()))
        report["unaliased_donated_leaves"] = moved
        if assert_donation and moved:
            raise RuntimeError(
                f"train-step donation leaked a copy: {moved} of {len(before)} "
                f"parameter and moment leaves were written to new storage "
                f"instead of in place (train/optimizer.py apply_updates)")
        return report

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
                    if self.dp is not None:
                        self.dp.preempted, self.dp.preempt_vote = preempt.preempted, None
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
                    eval_iv = cfg.train.eval_interval
                    if eval_iv and (step + 1) % eval_iv == 0:
                        extras["eval_loss"] = self.evaluate(state["params"])
                        log.info("eval at step %d: loss %.4f", step + 1, extras["eval_loss"])
                        watch.lap()   # eval time out of the next step's time
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
                    if self._preempted(preempt):
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
