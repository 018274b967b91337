#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``orion_tpu_torch``) on one GPU.

    python3 chip_smoke.py                 # every phase, as the check runs it
    python3 chip_smoke.py --phases device,build,kernels
    python3 chip_smoke.py --phases device,build,serve --profile

Phases, each printing one JSON line; any failure raises and the script
exits non-zero without printing a result:

  device   the card's name and power limit (nvidia-smi); fails without CUDA
  build    nvcc builds every ``orion_tpu_torch/csrc/*.cu`` (one process each,
           started together); the compiler's register/shared-memory report
           goes to chiprun_out/chip_smoke_build.log
  kernels  K1-K4 against their plain PyTorch versions on the card, at the
           serving path's shapes, in float32 and bfloat16 (tolerances below);
           K4's written pool rows must be byte-identical (page 0 excluded)
  parity   a tiny-llama float32 engine on cuda (kernels) and on cpu (plain
           versions), same seeded weights, six prompts against four slots:
           the greedy token lists must be equal
  serve    llama3-8b-infer at full width and depth, seeded random bf16
           weights on the card, 16 greedy requests of 100-2000 prompt tokens
           and 64 new tokens; every request finishes, tokens are in the vocab,
           prefill logits are finite, and every kernel launched in the serve
  timing   each kernel at the ``kernels`` shapes in bfloat16: median of 20
           CUDA-event timings after a warm-up, beside its plain version, one
           PyTorch library call computing the same function where there is
           one, and the card's bound for the work

Then a ``{"kernels": [...]}`` line, the nvidia-smi name/power-limit line,
and last ``{"ok": true, "device": {...}}``.

Bounds use the H100 SXM data sheet: 3.35 TB/s of HBM, 989 TFLOP/s for bf16
products on the tensor cores, 67 TFLOP/s for f32 elementwise work.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")
PHASES = ("device", "build", "kernels", "parity", "serve", "timing")

HBM_BYTES_S = 3.35e12
BF16_FLOPS_S = 989e12
F32_FLOPS_S = 67e12

# (atol, rtol) per kernel and dtype. f32: both sides do f32 math in another
# order (and K3/K4 sum up to 8192 terms); bf16: the plain versions round
# the softmax probabilities to bf16 before P@V as the JAX op does, and
# every output rounds to bf16 (2^-8 relative).
TOL = {
    "rmsnorm_fwd": {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)},
    "rope_fwd": {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)},
    "flash_fwd": {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)},
    "paged_decode": {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)},
}

KERNEL_META = {
    "rmsnorm_fwd": dict(route="triton", source="orion_tpu_torch/ops/norms.py",
                        replaces="orion_tpu/ops/pallas/norms.py:51"),
    "rope_fwd": dict(route="triton", source="orion_tpu_torch/ops/rope.py",
                     replaces="orion_tpu/ops/pallas/rope.py:52"),
    "flash_fwd": dict(route="cuda", source="orion_tpu_torch/csrc/flash_fwd.cu",
                      replaces="orion_tpu/ops/pallas/flash_attention.py:353"),
    "paged_decode": dict(route="cuda", source="orion_tpu_torch/csrc/paged_decode.cu",
                         replaces="orion_tpu/ops/pallas/paged_attention.py:305"),
}

# Shapes of the kernels phase (the serving path's at llama3-8b-infer).
K1_ROWS, D_MODEL = 4 * 2048, 4096
B_PRE, S_PRE, N_HEADS, N_KV, HEAD = 4, 2048, 32, 8, 128
PRE_LENS = (2048, 1500, 700, 1)
B_DEC, PSZ, NUM_PAGES, N_LAYERS = 32, 64, 2048, 32


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def bits(t):
    """The tensor's bytes as integers, for exact comparison."""
    return t.contiguous().view(torch_int_of(t))


def torch_int_of(t):
    import torch

    return {torch.bfloat16: torch.int16, torch.float32: torch.int32}[t.dtype]


def max_err(a, b, rows=None) -> float:
    d = (a.float() - b.float()).abs()
    if rows is not None:
        d = d[rows]
    return float(d.max()) if d.numel() else 0.0


def require_close(name, dtype_name, a, b, rows=None) -> float:
    import torch

    atol, rtol = TOL[name][dtype_name]
    x, y = a.float(), b.float()
    if rows is not None:
        x, y = x[rows], y[rows]
    if not torch.isfinite(x).all():
        raise AssertionError(f"{name} {dtype_name}: non-finite kernel output")
    if not torch.allclose(x, y, atol=atol, rtol=rtol):
        raise AssertionError(
            f"{name} {dtype_name}: max |kernel - plain| = {max_err(a, b, rows)} "
            f"exceeds atol={atol} rtol={rtol}"
        )
    return max_err(a, b, rows)


# ---------------------------------------------------------------------------
# Inputs at the serving path's shapes
# ---------------------------------------------------------------------------


def k1_inputs(dtype, gen):
    import torch

    x = torch.randn(K1_ROWS, D_MODEL, generator=gen, device="cuda").to(dtype)
    s = (1.0 + 0.1 * torch.randn(D_MODEL, generator=gen, device="cuda")).to(dtype)
    return x, s


def k2_inputs(dtype, gen):
    import torch

    q = torch.randn(B_PRE, S_PRE, N_HEADS, HEAD, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B_PRE, S_PRE, N_KV, HEAD, generator=gen, device="cuda").to(dtype)
    # Row b holds positions b*2048 .. b*2048+2047: up to 8191.
    pos = (torch.arange(S_PRE, device="cuda")[None]
           + S_PRE * torch.arange(B_PRE, device="cuda")[:, None]).to(torch.int32)
    return q, k, pos


def k3_inputs(dtype, gen):
    import torch

    q = torch.randn(B_PRE, S_PRE, N_HEADS, HEAD, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B_PRE, S_PRE, N_KV, HEAD, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B_PRE, S_PRE, N_KV, HEAD, generator=gen, device="cuda").to(dtype)
    lens = torch.tensor(PRE_LENS, device="cuda")
    seg = (torch.arange(S_PRE, device="cuda")[None] < lens[:, None]).to(torch.int32)
    return q, k, v, seg


def k4_inputs(dtype, gen):
    """32 slots over the full preset pool at layer 31: slots 0 and 1 idle
    (all-zero page table, scratch page 0), the rest with ragged contexts
    up to 8191 on distinct pages."""
    import torch

    P = 8192 // PSZ
    rows = N_LAYERS * NUM_PAGES
    k_pool = torch.randn(rows, N_KV, PSZ, HEAD, generator=gen, device="cuda").to(dtype)
    v_pool = torch.randn(rows, N_KV, PSZ, HEAD, generator=gen, device="cuda").to(dtype)
    last_pos = [0, 0] + [int(8191 * ((b + 1) / B_DEC) ** 2) for b in range(2, B_DEC)]
    perm = torch.randperm(NUM_PAGES - 1, generator=gen, device="cuda") + 1
    table = torch.zeros(B_DEC, P, dtype=torch.int32, device="cuda")
    used = 0
    for b in range(2, B_DEC):
        n = last_pos[b] // PSZ + 1
        table[b, :n] = perm[used:used + n].to(torch.int32)
        used += n
    assert used <= NUM_PAGES - 1, used
    q = torch.randn(B_DEC, N_HEADS, HEAD, generator=gen, device="cuda").to(dtype)
    kn = torch.randn(B_DEC, N_KV, HEAD, generator=gen, device="cuda").to(dtype)
    vn = torch.randn(B_DEC, N_KV, HEAD, generator=gen, device="cuda").to(dtype)
    lp = torch.tensor(last_pos, dtype=torch.int32, device="cuda")
    return q, k_pool, v_pool, table, lp, kn, vn, (N_LAYERS - 1) * NUM_PAGES


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    line = smi_line()
    emit({"phase": "device", "nvidia_smi": line,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return line


def phase_build():
    from orion_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    secs = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_build.log"), "w") as f:
        for name, log in logs.items():
            f.write(f"== {name}\n{log}\n")
    emit({"phase": "build", "seconds": secs, "sources": list(logs)})


def check_k4(dtype, gen, plain, cuda):
    """K4 kernel vs plain: outputs of the live slots, and the written pool
    rows byte for byte (the two runs start from the same pool bytes)."""
    import torch

    q, kp, vp, table, lp, kn, vn, base = k4_inputs(dtype, gen)
    live = torch.arange(B_DEC, device="cuda") >= 2
    wrows = base + table[torch.arange(B_DEC, device="cuda"), lp // PSZ].long()
    wrows = wrows[live]
    snap_k, snap_v = kp[wrows].clone(), vp[wrows].clone()
    out_k, _, _ = cuda(q, kp, vp, table, lp, layer_base=base, k_new=kn, v_new=vn)
    torch.cuda.synchronize()
    rows_k = (kp[wrows].clone(), vp[wrows].clone())
    kp[wrows], vp[wrows] = snap_k, snap_v
    out_p, _, _ = plain(q, kp, vp, table, lp, layer_base=base, k_new=kn, v_new=vn)
    rows_p = (kp[wrows], vp[wrows])
    if not all(torch.equal(bits(a), bits(b)) for a, b in zip(rows_k, rows_p)):
        raise AssertionError("paged_decode: written pool rows differ from the plain version")
    col = (lp % PSZ).long()[live]
    got = rows_k[0][torch.arange(len(col), device="cuda"), :, col]
    if not torch.equal(got, kn[live]):
        raise AssertionError("paged_decode: the new token's K is not in its pool slot")
    err = require_close("paged_decode", str(dtype).split(".")[-1], out_k, out_p, rows=live)
    del q, kp, vp
    return err


def phase_kernels():
    import torch

    from orion_tpu_torch import ops

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        x, s = k1_inputs(dtype, gen)
        e1 = require_close("rmsnorm_fwd", dn, ops.rmsnorm_triton(x, s, 1e-5),
                           ops.rmsnorm_plain(x, s, 1e-5))
        q, k, pos = k2_inputs(dtype, gen)
        e2 = max(
            require_close("rope_fwd", dn, ops.rope_triton(t, pos, 500000.0),
                          ops.rope_plain(t, pos, 500000.0))
            for t in (q, k)
        )
        q, k, v, seg = k3_inputs(dtype, gen)
        kw = dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg)
        real = seg > 0   # padded rows hold garbage the caller discards
        e3 = require_close(
            "flash_fwd", dn, ops.flash_attention_cuda(q, k, v, seg_pad_zero=True, **kw),
            ops.attention_plain(q, k, v, **kw), rows=real,
        )
        del q, k, v
        torch.cuda.empty_cache()
        e4 = check_k4(dtype, gen, ops.paged_attention_plain, ops.paged_attention_cuda)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        errs[dn] = {"rmsnorm_fwd": e1, "rope_fwd": e2, "flash_fwd": e3, "paged_decode": e4}
        emit({"phase": "kernels", "dtype": dn, "max_abs_err": errs[dn],
              "tolerance": {k: TOL[k][dn] for k in TOL}})
    variants = kernel_variants(gen)
    emit({"phase": "kernels", "variants": variants})
    return errs


def kernel_variants(gen):
    import torch

    from orion_tpu_torch import ops

    out = []
    for H, N, K, S, window, cap, off in (
        (16, 4, 2, 77, None, None, 0), (64, 8, 2, 300, 64, 30.0, 0),
        (128, 4, 4, 200, None, 50.0, 5), (256, 2, 1, 129, 17, None, 0),
    ):
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            q = torch.randn(2, S, N, H, generator=gen, device="cuda").to(dtype)
            k = torch.randn(2, S + off, K, H, generator=gen, device="cuda").to(dtype)
            v = torch.randn(2, S + off, K, H, generator=gen, device="cuda").to(dtype)
            kw = dict(causal=True, logit_softcap=cap, window=window, q_offset=off)
            e3 = require_close("flash_fwd", dn, ops.flash_attention_cuda(q, k, v, **kw),
                               ops.attention_plain(q, k, v, **kw))
            psz, P, B = 16, 8, 3
            kp = torch.randn(40, K, psz, H, generator=gen, device="cuda").to(dtype)
            vp = torch.randn(40, K, psz, H, generator=gen, device="cuda").to(dtype)
            lp = torch.tensor([0, 37, P * psz - 1], dtype=torch.int32, device="cuda")
            ids = (torch.randperm(19, generator=gen, device="cuda") + 1).to(torch.int32)
            table = torch.zeros(B, P, dtype=torch.int32, device="cuda")
            table[0, :1], table[1, :3], table[2, :8] = ids[:1], ids[1:4], ids[4:12]
            qd = torch.randn(B, N, H, generator=gen, device="cuda").to(dtype)
            kn = torch.randn(B, K, H, generator=gen, device="cuda").to(dtype)
            vn = torch.randn(B, K, H, generator=gen, device="cuda").to(dtype)
            kp2, vp2 = kp.clone(), vp.clone()
            kw4 = dict(layer_base=20, k_new=kn, v_new=vn, logit_softcap=cap, window=window)
            o_k, kp, vp = ops.paged_attention_cuda(qd, kp, vp, table, lp, **kw4)
            o_p, kp2, vp2 = ops.paged_attention_plain(qd, kp2, vp2, table, lp, **kw4)
            if not (torch.equal(kp, kp2) and torch.equal(vp, vp2)):
                raise AssertionError(f"paged_decode variant H={H} {dn}: pools differ")
            e4 = require_close("paged_decode", dn, o_k, o_p)
            out.append({"H": H, "N": N, "K": K, "window": window, "softcap": cap,
                        "q_offset": off, "dtype": dn, "flash_fwd": e3, "paged_decode": e4})
    return out



INFER_OVERRIDES = [
    "inference.max_seq_len=128", "inference.page_size=16",
    "inference.num_pages=32", "inference.max_batch_size=4",
    "inference.prefill_chunk=16", "inference.max_new_tokens=8",
]


def phase_parity():
    import torch

    from orion_tpu_torch.config import get_config
    from orion_tpu_torch.infer import InferenceEngine
    from orion_tpu_torch.models import init_params

    cfg = get_config("tiny-llama", INFER_OVERRIDES)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = init_params(cfg.model, gen)
    prompts = [[5, 3, 9], [250, 17, 4, 8, 100, 42], [7] * 20, [1, 2],
               [99, 98, 97, 96], [11, 13, 17, 19, 23]]
    gpu = InferenceEngine(cfg, params, device="cuda").generate(prompts, 6)
    cpu = InferenceEngine(cfg, params, device="cpu").generate(prompts, 6)
    if gpu != cpu:
        raise AssertionError(f"tiny-llama streams differ: cuda {gpu} cpu {cpu}")
    emit({"phase": "parity", "preset": "tiny-llama", "requests": len(prompts),
          "equal": True, "cuda_streams": gpu})


def profile_serve(eng, prompts):
    """Drive the same requests again under torch.profiler: device time by
    kernel group and the device's idle share of the drive's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    groups = {"rmsnorm_fwd": "_rmsnorm_fwd", "rope_fwd": "_rope_fwd",
              "flash_fwd": "flash_fwd_kernel", "paged_decode": "paged_decode_kernel"}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for p in prompts:
            eng.submit_request(p, 64)
        while eng.has_work():
            eng.step()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        rows.append((evt.key, us, evt.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    by_group = {g: 0.0 for g in groups}
    for key, us, _ in rows:
        for g, pat in groups.items():
            if pat in key:
                by_group[g] += us
    by_group["other"] = busy - sum(by_group.values())
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "serve_profile.txt"), "w") as f:
        for key, us, n in rows:
            f.write(f"{us / 1e3:12.3f} ms  {n:7d}  {key}\n")
    emit({"phase": "serve_profile", "wall_ms": wall_us / 1e3,
          "device_busy_ms": busy / 1e3, "device_idle_share": 1 - busy / wall_us,
          "device_ms_by_group": {g: us / 1e3 for g, us in by_group.items()},
          "top": [{"kernel": k[:80], "ms": us / 1e3, "count": n} for k, us, n in rows[:12]]})


def phase_serve(profile=False):
    import numpy as np
    import torch

    from orion_tpu_torch import ops
    from orion_tpu_torch.config import get_config
    from orion_tpu_torch.infer import InferenceEngine
    from orion_tpu_torch.models import init_params

    cfg = get_config("llama3-8b-infer")
    V = cfg.model.vocab_size
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg.model, gen, device="cuda", dtype="bfloat16")
    eng = InferenceEngine(cfg, params, device="cuda")
    del params
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    finite = []
    sample = eng._sample

    def checked_sample(logits, reqs):
        finite.append(bool(torch.isfinite(logits[: len(reqs)]).all()))
        return sample(logits, reqs)

    eng._sample = checked_sample
    rng = np.random.default_rng(0)
    lens = np.linspace(100, 2000, 16).astype(int)
    prompts = [rng.integers(0, V, size=n).tolist() for n in lens]
    # Warm-up, as a server does at start: one short request compiles the
    # Triton kernels and settles cuBLAS, so TTFT measures serving, not JIT.
    eng.generate([rng.integers(0, V, size=100).tolist()], 2)
    eng.timing = {k: 0 for k in eng.timing}
    finite.clear()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    reqs = [eng.submit_request(p, 64) for p in prompts]
    while eng.has_work():
        eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches()

    for r in reqs:
        if not (r.done and r.outcome == "completed" and len(r.generated) == 64):
            raise AssertionError(f"request {r.rid}: outcome {r.outcome!r}, "
                                 f"{len(r.generated)} tokens")
        if not all(0 <= t < V for t in r.generated):
            raise AssertionError(f"request {r.rid}: token outside the vocab")
    if not (finite and all(finite)):
        raise AssertionError("non-finite prefill logits")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels never launched in the serve: {missing}")
    tm = eng.timing
    ttft = sorted(r.t_first - r.t_submit for r in reqs)
    decode_tokens = sum(len(r.generated) - 1 for r in reqs)
    emit({
        "phase": "serve", "preset": "llama3-8b-infer", "requests": len(reqs),
        "prompt_tokens": int(lens.sum()), "new_tokens_each": 64,
        "setup_s": setup_s, "wall_s": wall,
        "ttft_s_median": statistics.median(ttft), "ttft_s_max": ttft[-1],
        "prefill_s": tm["prefill_s"], "prefill_tokens": tm["prefill_tokens"],
        "prefill_tok_s": tm["prefill_tokens"] / tm["prefill_s"],
        "decode_s": tm["decode_s"], "decode_tokens": decode_tokens,
        "decode_tok_s": decode_tokens / tm["decode_s"],
        "decode_slot_steps": tm["decode_slot_steps"], "steps": tm["steps"],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": launches,
    })
    if profile:
        profile_serve(eng, prompts)
    del eng
    torch.cuda.empty_cache()
    return launches


def time_ms(fn, reps=20):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes, flops, rate):
    tb, tf = nbytes / HBM_BYTES_S * 1e3, flops / rate * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def phase_timing():
    import torch
    import torch.nn.functional as F

    from orion_tpu_torch import ops

    dt = torch.bfloat16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    res = {}

    x, s = k1_inputs(dt, gen)
    nb = 2 * x.numel() * 2 + s.numel() * 2
    res["rmsnorm_fwd"] = dict(
        ms=time_ms(lambda: ops.rmsnorm_triton(x, s, 1e-5)),
        plain_ms=time_ms(lambda: ops.rmsnorm_plain(x, s, 1e-5)),
        library_ms=time_ms(lambda: F.rms_norm(x, (D_MODEL,), s, 1e-5)),
        bound=bound(nb, 4 * x.numel(), F32_FLOPS_S))
    del x

    q, k, pos = k2_inputs(dt, gen)

    def rope_both(fn):
        return lambda: (fn(q, pos, 500000.0), fn(k, pos, 500000.0))

    nb = 2 * 2 * (q.numel() + k.numel()) + 2 * pos.numel() * 4
    res["rope_fwd"] = dict(
        ms=time_ms(rope_both(ops.rope_triton)),
        plain_ms=time_ms(rope_both(ops.rope_plain)),
        library_ms=None,
        bound=bound(nb, 6 * (q.numel() + k.numel()), F32_FLOPS_S))
    del q, k

    q, k, v, seg = k3_inputs(dt, gen)
    kw = dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg)
    pairs = sum(n * (n + 1) // 2 for n in PRE_LENS)
    nb = 2 * (2 * q.numel() + k.numel() + v.numel()) + 2 * seg.numel() * 4
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(N_HEADS // N_KV, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(N_HEADS // N_KV, dim=2).transpose(1, 2)
    mask = (ops.attention_mask(S_PRE, S_PRE, causal=True, q_segment_ids=seg,
                               kv_segment_ids=seg))[:, None]
    res["flash_fwd"] = dict(
        ms=time_ms(lambda: ops.flash_attention_cuda(q, k, v, seg_pad_zero=True, **kw)),
        plain_ms=time_ms(lambda: ops.attention_plain(q, k, v, **kw)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)),
        bound=bound(nb, 4 * HEAD * N_HEADS * pairs, BF16_FLOPS_S))
    del q, k, v, qt, kt, vt, mask
    torch.cuda.empty_cache()

    q, kp, vp, table, lp, kn, vn, base = k4_inputs(dt, gen)
    kw = dict(layer_base=base, k_new=kn, v_new=vn)
    ctx = int((lp.long() + 1).sum())
    nb = (2 * q.numel() * 2 + 2 * kn.numel() * 2 + 2 * ctx * N_KV * HEAD * 2
          + table.numel() * 4 + lp.numel() * 4)
    P = table.shape[1]
    kc = kp[base + table.long()].permute(0, 2, 1, 3, 4).reshape(B_DEC, N_KV, P * PSZ, HEAD)
    vc = vp[base + table.long()].permute(0, 2, 1, 3, 4).reshape(B_DEC, N_KV, P * PSZ, HEAD)
    kc = kc.repeat_interleave(N_HEADS // N_KV, dim=1)
    vc = vc.repeat_interleave(N_HEADS // N_KV, dim=1)
    dmask = (torch.arange(P * PSZ, device="cuda")[None] <= lp[:, None].long())[:, None, None]
    res["paged_decode"] = dict(
        ms=time_ms(lambda: ops.paged_attention_cuda(q, kp, vp, table, lp, **kw)),
        plain_ms=time_ms(lambda: ops.paged_attention_plain(q, kp, vp, table, lp, **kw)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kc, vc, attn_mask=dmask)),
        bound=bound(nb, 4 * N_HEADS * HEAD * ctx, BF16_FLOPS_S))
    del q, kp, vp, kc, vc
    torch.cuda.empty_cache()
    for name, r in res.items():
        emit({"phase": "timing", "kernel": name, "dtype": "bfloat16", "ms": r["ms"],
              "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
              "bound_ms": r["bound"][0], "bound_by": r["bound"][1]})
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--phases", default=",".join(PHASES),
                        help=f"comma-separated subset of {','.join(PHASES)}")
    parser.add_argument("--profile", action="store_true",
                        help="after the serve, drive the same requests again "
                             "under torch.profiler (table in chiprun_out/)")
    args = parser.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import orion_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    line = phase_device()
    errs = launches = timing = None
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        errs = phase_kernels()
    if "parity" in phases:
        phase_parity()
    if "serve" in phases:
        launches = phase_serve(args.profile)
    if "timing" in phases:
        timing = phase_timing()
    if errs and launches and timing:
        emit({"kernels": [
            dict(name=name, **KERNEL_META[name], launches=launches[name],
                 max_abs_err=errs["bfloat16"][name], ms=timing[name]["ms"],
                 plain_ms=timing[name]["plain_ms"], bound_ms=timing[name]["bound"][0],
                 bound_by=timing[name]["bound"][1], library_ms=timing[name]["library_ms"])
            for name in KERNEL_META
        ]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start, "phases": phases})
    print(line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
