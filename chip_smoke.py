#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``orion_tpu_torch``) on one GPU.

    python3 chip_smoke.py                 # every phase, as the check runs it
    python3 chip_smoke.py --phases device,build,kernels
    python3 chip_smoke.py --phases device,build,serve --profile
    python3 chip_smoke.py --phases device,build,train --profile
    python3 chip_smoke.py --phases device,build,serve_spec --profile
    python3 chip_smoke.py --phases device,build,train_faults
    python3 chip_smoke.py --phases device,build,serve_graphs
    python3 chip_smoke.py --phases device,build,kernels,serve_host_tier,serve_long,serve_gather
    python3 chip_smoke.py --phases device,build,serve,serve_obs,train,train_obs

Phases, each printing one JSON line; any failure raises and the script
exits non-zero without printing a result:

  device   the card's name and power limit (nvidia-smi); fails without CUDA
  build    nvcc builds every ``orion_tpu_torch/csrc/*.cu`` (one process each,
           started together); the compiler's register/shared-memory report
           goes to chiprun_out/chip_smoke_build.log
  kernels  K1-K10 and K4's, K9's, K10's and K3-pos's split merges against their plain
           PyTorch versions on the card (the backward kernels against
           autograd of the plain forward; K5's scale gradient too, within
           TOL["rmsnorm_dscale"], also beside a float32 scale), at the
           serving path's and the training path's shapes, in float32 and
           bfloat16 (tolerances in TOL), K4, K9 and K10 also over int8
           pools; what K4, K9 and K10 write into the pools (int8 pages and
           float32 scales too) must be byte-identical to the plain
           versions' writes (scratch page 0 excluded), K9 must leave
           history pages and scale lanes past the page untouched and K10
           every row it does not own; off-path variants (segments under
           seg_pad_zero, windows, softcaps, q_offset, rows that attend
           nothing, pad rows, page size 16, head_dim 16-256; for K10 token
           trees with and without a window, W 8, 31 and 64 (bf16 only: the
           float32 fit check refuses it), G 8 at head_dim 16, a slot over all
           16 splits of a 128-page table, drafts straddling a split boundary
           (chain, tree, tree under a window whose context opens a split
           before the chain's), a chain-shaped tree bitwise against the
           chain, W = 1 against K4; for K9 histories over
           three splits, a split boundary inside the window, G 1-8, page 128;
           for K8 padding off its 64-key tiles and fewer keys than one tile;
           for K4's split walk, in both pools and dtypes, contexts of one
           split exactly, a key past it and the whole table, windows whose
           edge falls inside a split, G 1-128, pages 16-128, H 16-256, up
           to 16 splits); every live K4 slot and every real K10 query row
           also within K4_SLOT_REL of its output RMS; two bf16 K4 launches,
           and two bf16 K10 launches in each pool branch, on the same inputs
           give the same bits; K1 and K5 (dx and the scale gradient) against
           rmsnorm_plain / rmsnorm_bwd_plain over NORM_D x NORM_R in float32,
           bfloat16 and bfloat16 rows beside a float32 scale, and on rows
           that are not 16-byte aligned; two K5 launches give the same bits,
           dx and the scale gradient's partial rows; NaN containment of K4,
           K10 and K9 in both pool branches (nan_containment): a page in
           the first split of one slot's walk poisoned as poison_page does
           it (bf16: K rows NaN; int8: k_scale rows NaN) makes every output
           row of that slot non-finite and leaves every other slot's output
           and pool writes bitwise as a clean launch; after scrub_pages of
           the page, every output is bitwise the clean launch's again; K3's
           explicit-positions branch in both dtypes at the gather body's
           layout (4 rows over prefixes of 0-7936 tokens, 256-token tails;
           no window and 4096) and a striped permutation at the training
           shapes, output and lse; bf16 (the split walk and its merge): two
           launches give the same bits, the split run within TOL of the
           one-split run, a shape whose blocks mostly have splits with no
           live step and a row that attends nothing (zeros, lse NEG_INF),
           and the merge against its plain version; identity positions on
           one split bitwise K3's index path; K7's and K8's
           explicit-positions branches (K7-pos, K8-pos) in both dtypes
           against autograd of the plain attention and its lse with the same
           positions and a nonzero lse cotangent: the striped permutation
           at the training shapes without and with a window, two launches
           bitwise, and a windowed ring's past block whose query rows from
           POSB_WINDOW - 1 on attend nothing (zero, finite gradients there)
  parity   a tiny-llama float32 engine on cuda (kernels) and on cpu (plain
           versions), same seeded weights, six prompts against four slots;
           the same prompts on cuda with every dispatch eager
           (cuda_graphs=False): greedy streams equal to the captured run's,
           and sampled ones (seed 3, per-slot and scalar sampling) equal
           captured and eager; then twice with chunked prefill and the prefix cache (float32
           pools, then int8 pools) over two waves that share a system
           prompt (prefix hits and one copy-on-write admission): the greedy
           token lists must be equal; then three speculative runs (chain,
           tree width 2, tree width 2 with int8 pools, chunked prefill and
           the prefix cache) over cyclic prompts whose streams must equal
           the cpu run's and the cuda spec-off run's, with equal counters;
           then a fault schedule (the NaN guard, a queue limit with mixed
           priorities, a NaN at step 2, a decode dispatch fault at step 3, a
           cancel of a waiting and an active request, a deadline set to now,
           a pool fault at a page growth, drain() with never-started
           requests queued) and a max_step_faults run that must re-raise:
           outcomes, streams and RobustnessStats equal on cuda and cpu; then
           grammar-constrained decoding (a forced regex, a JSON schema and an
           unconstrained neighbour, chain speculation): streams and
           ConstraintStats counters equal on cuda and cpu
  serve    llama3-8b-infer at full width and depth, seeded random bf16
           weights on the card, 16 greedy requests of 100-2000 prompt tokens
           and 64 new tokens; every request finishes, tokens are in the vocab,
           prefill logits are finite, and every kernel launched in the serve
  serve_obs  the serve with the obs layer (``orion_tpu_torch/obs``), on the
           serve's weights: llama3-8b-infer at full width and depth, the
           serve's 16 requests in three waves (the first captures the graphs),
           CUDA graphs on, untraced and then with inference.trace,
           trace_path, flight_dir, metrics_jsonl and metrics_prom under
           chiprun_out/serve_obs/. The traced streams equal the untraced
           ones, with the same launches and graph captures and replays;
           the Chrome trace parses with no event dropped, each path's
           dispatch/<path> spans equal the executor's runs of that path,
           the step spans the steps, and each request has one first_token
           and one completed outcome instant; every metrics row and the
           Prometheus file carry the hbm gauges, 0 < bytes_in_use <=
           bytes_limit. Then 4 of the requests with the NaN guard, clean
           and then traced with a flight recorder and a NaN injected at
           step 2: exactly one nan_quarantine dump carrying the
           injected_fault event, the other 3 streams the clean run's.
           Prints the later waves' decode tokens/s and median host share
           of a decode-only step, untraced and traced, on a line of its
           own (recorded, not gated)
  serve_chunked  llama3-8b-infer at full width and depth with int8 KV, the
           prefix cache and chunked prefill (the serve's weights): two
           waves of 8 greedy requests sharing a 1024-token system prompt,
           64 new tokens each; the second wave hits the cache, one of its
           prompts whole (copy-on-write). Every request finishes, prefill
           logits are finite, K1-K3, K4's and K9's int8 branches and both
           merges launch, the page accounting holds and clearing the cache
           frees the pool
  serve_spec  llama3-8b-infer at full width and depth with speculative
           decoding (the serve's weights): 8 greedy requests of 100-1000
           random prompt tokens, then the same 8 again (the first wave's
           pages in the prefix tree are the drafter's source), 64 new tokens
           each, in drives A (chain, bf16 pools), A0 (A without speculation)
           and B (tree width 2, int8 pools, chunked prefill); every request
           finishes, wave 2 verifies (and accepts drafts in A), K10's
           branches and its merge launch (K4 and its merge in A0 and B),
           the page accounting holds
  serve_constrained  llama3-8b-infer at full width and depth (the serve's
           weights) with grammar-constrained decoding, eos V - 1: C1, 16
           greedy requests of 100-1000 prompt tokens, 4 under JSON schemas
           and 4 under regexes, bf16 pools and the prefix cache; A0 the same
           prompts unconstrained with constrained=false; C2 = C1 with int8
           pools, chunked prefill and tree speculation of width 2; C0, 8
           unconstrained requests under constrained=true, byte-identical to
           constrained=false. Every constrained stream re-walks its grammar
           from the start state through a fresh compile (a completion ends
           accepting), no fault is contained, K10 (C1) and K10-int8 (C2)
           launch; prints each pattern's compile seconds at V = 128256, the
           mask build and copy times per step and decode tokens/s beside A0
  serve_faults  llama3-8b-infer at full width and depth (the serve's
           weights), the lifecycle and fault containment in four drives:
           F1 (bf16 pool, NaN guard, 8 slots, queue of 8: the rule's two
           sheds, admission by priority, a NaN quarantine at step 3, a
           failed decode step, cancels, an expiry, drain), F2 (the chunked
           serve's configuration: a NaN victim mid-decode through K4-int8
           and one mid-prompt through K9-int8, none of their pages cached),
           F3 (the speculative drive A: three verify faults switch
           speculation off, K10 stops and K4 goes on) and F4 (F1 with the
           NaN victim cancelled instead: every stream completed in both
           byte-identical to F1's). Each drive prints its outcome counts,
           RobustnessStats, launches, wall seconds and the card. First, the
           sticky-error row: a tiny-llama bf16 engine in a subprocess, a
           device-side assert launched inside a decode step right after
           its window's replay (sticky_child); the step must fail inside the envelope,
           every step after it too, counted once each, the engine must
           re-raise after inference.max_step_faults failed steps, and no
           token may be appended after the fault
  serve_graphs  llama3-8b-infer at full width and depth (the serve's
           weights): the engine's dispatch programs as CUDA graphs against
           the same dispatches run eagerly (cuda_graphs=False). (a) one
           decode window, one chain verify and one tree verify of the
           serve's batch after its prefill: outputs equal, the written
           pool rows byte for byte, every step's logits within
           TOL["graph_logits"]; (b) the serve's 16 requests eager, then
           captured: decode tokens/s, TTFT, the host share of a decode step
           (1 - the window's device time alone over the step's wall),
           capture seconds, graph pool bytes, launches (equal both ways),
           every decode window a replay, the eager prefill's enqueue beside
           its device time; (c) the captured serve under
           inference.decode_window_autotune: the window's path and rate
  serve_host_tier  llama3-8b-infer at full width and depth (the serve's
           weights), the prefix cache over a 320-page pool and a host tier
           of a quarter of the free RAM, at most 4 GiB: 8 distinct
           2048-token prompts, then 8 others (their allocations demote the
           first wave's pages), then the first 8 with 100-token tails
           (restored, one batched copy a hit); the restored pages bit for
           bit the demoted ones, waves 1 and 3 token for token those of a
           2048-page pool that evicts nothing; pinned-memory d2h/h2d GB/s,
           the restore time a call and its overhead, the break-even
           threshold from the measured constants beside the defaults,
           offload_prefix_cache, and a "restore" fault unwound on both
           tiers (the step fails once, the request completes)
  serve_gather  llama3-8b-infer with the prefix cache and
           paged_prefill=false: a second wave's hits run the gather body
           (K3 with positions and its merge, no K9); each warm row's first logits within
           GATHER_LOGIT_REL (relative RMS) of the paged_prefill=true
           engine's; tiny-llama float32: both settings' streams equal
  serve_long  Mistral-7B (mistral-7b-fsdp, parallel.fsdp=1: window 4096 on
           all 32 layers) at full width and depth, seeded bf16 weights after
           the Llama weights are freed: two 8064-token prompts at once over
           96 pages (one spans 127), chunked by 512, a residency cap of 32
           pages; page rolling, demotion, page-ins and a preemption to the
           host fire, peak device pages stay inside the pool, and the
           streams equal the long_context=false run's over 300 pages
  train_parity  tiny-llama float32, packed batches: the first step's loss
           and every gradient, then 3 optimizer steps, on cuda (kernels)
           and on cpu (plain versions) from the same seeded weights and
           batches; within TRAIN_TOL
  train    llama-1b-bench at full width and depth (16 layers, d_model 2048,
           batch 8 x 2048, remat=full, bf16 compute, f32 master weights,
           bf16 moments), seeded random weights on the card: one warm-up
           step, then TRAIN_STEPS measured steps through Trainer.fit; the
           loss must be finite and fall, and K1-K3 and K5-K8 must launch;
           prints step time, tokens/s, MFU, peak memory, launches per step
  train_obs  llama-1b-bench at full width and depth, 4 steps through
           Trainer.fit with train.trace, flight_dir, metrics_prom and
           profile_steps=(2,3) under chiprun_out/train_obs/: 4 data,
           dispatch and train_step spans, no flight dump, the Prometheus
           file with the train loss and 0 < hbm bytes_in_use <=
           bytes_limit, and the profiler's Chrome trace holding only the
           train#2 range, with K3, K7 and K8 launched inside it. Prints the
           traced step times beside the train phase's median (untraced) on
           a line of its own
  sp_rank  one rank of llama3-8b-256k-ring's striped ring at the preset's
           widths (32/8 heads, head_dim 128, 16384 queries a rank, sp = 16
           ring steps of 16384 keys, batch 1, bf16): parallel.sequence's
           _striped_ring (_block_attend, _merge_blocks) forward and
           backward, each step's kv block sliced from a whole sequence on
           the card in place of the exchange (one H100: the ring's
           communication needs two cards or more), held against one
           positions-kernel call over the whole sequence for the rank's
           queries (out, lse, dq, dk, dv within SP_REL relative RMS); 16
           launches each of K3-pos, K7-pos and K8-pos and K3-pos's merges;
           then K7-pos and K8-pos against their plain version within TOL on
           one kv-head group (4/1 heads) of two of the ring's blocks, with
           an lse cotangent (the next rank's block leaves 1024 rows dead)
  train_faults  llama-1b-bench at full width and depth on the card, the
           checkpoint format and the training fault stack, in a temporary
           directory removed at the end (the free disk is printed first):
           R0, 6 steps saving every 2 (async, 2 kept); its final checkpoint
           restored to the host with and without the CRC pass; S, the
           serving CLI (``orion_tpu_torch.generate``) on R0's checkpoint: 4
           greedy requests whose streams must equal an engine's built from
           R0's final params in memory; R1, R0 under run_with_restarts with
           train.inject_fault_at_step=3: the emergency save commits step 3,
           the restart resumes there, and the final checkpoint must equal
           R0's leaf for leaf (sizes and CRCs), its losses R0's; R2, the
           anomaly guard (limit 2) with NaN-poisoned steps 3 and 4: each
           skipped with params and moments bitwise as before and the count
           unchanged, K5-K8 launched inside them, the rollback to step 4
           skipping 1 batch (rollbacks 1, skipped_batches 1, anomalous and
           nonfinite 2), then finite losses; R3, a commit torn at step 4:
           a fresh trainer quarantines it (truncated_array) and restores
           step 2; then the guarded and the unguarded step in turns. Prints
           checkpoint bytes, save (capture) and commit medians, restore
           times, the two step times, the free disk and K1-K3/K5-K8's
           launches
  timing   each kernel in bfloat16 at the ``kernels`` shapes (K1-K4, K9,
           K1 also at the training rows and the serve's decode batch, with
           its device time alone and the host's microseconds per call; K5
           with the scale gradient at the training rows, the same;
           K10: the serving path's, K4, K9 and K10 also over int8 pools, K10
           beside K4 at the same contexts, K4 again at the plain serve's
           decode batch and K10 at the speculative serve's verify batch, K4,
           K10 and their merges also by CUDA-graph replay; K5-K8, and K3
           again with its lse as ``flash_fwd_train``: the training path's;
           K7-pos and K8-pos at the striped training shapes, with their
           device time alone, bound from the admitted pairs):
           CUDA events around 5 runs of 5 back-to-back calls after a
           warm-up, the median per call, beside its plain version, one
           PyTorch library call computing the same function where there is
           one, and the card's bound for the work

On the card every engine's decode, verify and mixed dispatch replays a
CUDA graph (captured the first time its key comes up; prefill stays
eager) unless the phase asks for cuda_graphs=False. serve, serve_chunked,
serve_spec and serve_constrained, which inject no fault, require that
the engine contained none (no dispatch fault, failed step or pool fault):
a real kernel failure the envelope absorbed must not pass. Then a
``{"kernels": [...]}`` line, the nvidia-smi name/power-limit line, and
last ``{"ok": true, "device": {...}}``.

Bounds use the H100 SXM data sheet: 3.35 TB/s of HBM, 989 TFLOP/s for bf16
products on the tensor cores, 67 TFLOP/s for f32 elementwise work.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")
PHASES = ("device", "build", "kernels", "parity", "serve", "serve_obs", "serve_chunked",
          "serve_spec", "serve_constrained", "serve_faults", "serve_graphs",
          "serve_host_tier", "serve_gather", "serve_long", "train_parity",
          "train", "train_obs", "train_faults", "sp_rank", "timing")

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
    "flash_fwd_pos": {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)},
    "paged_decode": {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)},
    # K3's lse: both sides take the same float32 logits of the (upcast)
    # inputs and differ only in the order of the sum, in either dtype.
    "flash_lse": {"float32": (1e-4, 1e-4), "bfloat16": (1e-4, 1e-4)},
    # K5, K6: as K1, K2 (a row reduction / a rotation, then one rounding).
    "rmsnorm_bwd": {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)},
    # K5's scale gradient, by the dtype compared: (a, n) = within a times
    # the RMS of the plain values plus n bf16 ulps of each value (require_
    # dscale_close). float32: the sum of the partial rows, before any cast,
    # against the plain float32 sum (check_dscale), whatever the scale's
    # dtype; both sum up to 16384 float32 products per column in another
    # order, about 1e-5 of the RMS apart. bfloat16: the cast result beside
    # a bf16 scale; both sides round once, and two sums on either side of a
    # rounding boundary land one ulp (2^-8 to 2^-7 of the value) apart.
    "rmsnorm_dscale": {"float32": (1e-4, 0), "bfloat16": (1e-3, 1)},
    "rope_bwd": {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)},
    # K7, K8 against autograd of the plain attention: f32 sums of up to
    # 2048 terms per row in another order; bf16: the plain backward rounds
    # dP = dO.v^T and the products to bf16 (cuBLAS bf16 outputs) where the
    # kernels keep f32 until the one rounding of dq/dk/dv.
    "flash_dq": {"float32": (1e-4, 1e-4), "bfloat16": (5e-2, 5e-2)},
    "flash_dkv": {"float32": (1e-4, 1e-4), "bfloat16": (5e-2, 5e-2)},
    # K7-pos, K8-pos: as K7, K8 (check_flash_train's), the lse cotangent
    # summed in float32 on both sides.
    "flash_dq_pos": {"float32": (1e-4, 1e-4), "bfloat16": (5e-2, 5e-2)},
    "flash_dkv_pos": {"float32": (1e-4, 1e-4), "bfloat16": (5e-2, 5e-2)},
    # K9: as K3/K4 (f32 sums of up to 8448 terms in another order; bf16
    # probabilities rounded before P@V by the plain version only).
    "paged_prefill": {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)},
    # int8 branches (pools quantized from standard normal values): the
    # plain versions dequantize the pages into q's dtype (a bf16 rounding
    # of every K/V element) where the kernels scale the float32 logits and
    # probabilities; otherwise as their pool branches.
    "paged_decode_int8": {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)},
    "paged_prefill_int8": {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)},
    # K10 (both branches): as K4 (f32 sums of up to 8192 terms in another
    # order; bf16 probabilities rounded before P@V by the plain version
    # only; under int8 the plain version's bf16 rounding of dequantized K/V).
    "ragged_verify": {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)},
    "ragged_verify_int8": {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)},
    # K9's merge (bf16 only): float32 sums of up to 8 splits in another
    # order, then one bf16 rounding on both sides.
    "paged_prefill_merge": {"bfloat16": (1e-2, 1e-2)},
    # K4's merge (bf16 only): as K9's (float32 sums over a slot's splits in
    # another order, then one bf16 rounding on both sides).
    "paged_decode_merge": {"bfloat16": (1e-2, 1e-2)},
    # K10's merge (bf16 only): as K4's, per query row.
    "ragged_verify_merge": {"bfloat16": (1e-2, 1e-2)},
    # K3-pos's merge (bf16 only): as K9's (float32 sums over a block's
    # splits in another order, then one bf16 rounding on both sides).
    "flash_fwd_pos_merge": {"bfloat16": (1e-2, 1e-2)},
    # serve_graphs (a): a dispatch program's logits, captured against the
    # same program run eagerly: the same kernels on the same inputs, so
    # equal unless cuBLAS picks another GEMM algorithm under capture, which
    # sums each product in another order (bf16 activations: 2^-8 relative).
    "graph_logits": {"bfloat16": (2e-2, 2e-2)},
}

# K4, per live slot: max |kernel - plain| over the slot's N*H outputs,
# divided by the RMS of the plain version's outputs of that slot. A slot
# over n keys of random K/V has outputs of about n^-1/2, so at long
# contexts TOL's atol alone would pass a garbled split. The largest of a
# slot's outputs lies near 4 RMS, where the two sides' bf16 roundings may
# differ by one ulp, 2^-7 * 4 RMS = 2^-5 RMS; the bf16 rounding of the
# probabilities before P.V (the plain version against the row's max, the
# kernel against each warp's running one) adds about 2^-9 RMS. float32
# sits far inside the same bound.
K4_SLOT_REL = 2.0 ** -4

KERNEL_META = {
    "rmsnorm_fwd": dict(route="cuda", source="orion_tpu_torch/csrc/rmsnorm.cu",
                        replaces="orion_tpu/ops/pallas/norms.py:51"),
    "rope_fwd": dict(route="triton", source="orion_tpu_torch/ops/rope.py",
                     replaces="orion_tpu/ops/pallas/rope.py:52"),
    "flash_fwd": dict(route="cuda", source="orion_tpu_torch/csrc/flash_fwd.cu",
                      replaces="orion_tpu/ops/pallas/flash_attention.py:353"),
    "flash_fwd_pos": dict(route="cuda", source="orion_tpu_torch/csrc/flash_fwd.cu",
                          replaces="orion_tpu/ops/pallas/flash_attention.py:178"),
    "paged_decode": dict(route="cuda", source="orion_tpu_torch/csrc/paged_decode.cu",
                         replaces="orion_tpu/ops/pallas/paged_attention.py:305"),
    "rmsnorm_bwd": dict(route="cuda", source="orion_tpu_torch/csrc/rmsnorm.cu",
                        replaces="orion_tpu/ops/pallas/norms.py:51"),
    "rope_bwd": dict(route="triton", source="orion_tpu_torch/ops/rope.py",
                     replaces="orion_tpu/ops/pallas/rope.py:52"),
    "flash_dq": dict(route="cuda", source="orion_tpu_torch/csrc/flash_bwd.cu",
                     replaces="orion_tpu/ops/pallas/flash_attention.py:412"),
    "flash_dkv": dict(route="cuda", source="orion_tpu_torch/csrc/flash_bwd.cu",
                      replaces="orion_tpu/ops/pallas/flash_attention.py:447"),
    # The has_pos branches of _dq_kernel (:229) and _dkv_kernel (:274).
    "flash_dq_pos": dict(route="cuda", source="orion_tpu_torch/csrc/flash_bwd.cu",
                         replaces="orion_tpu/ops/pallas/flash_attention.py:229"),
    "flash_dkv_pos": dict(route="cuda", source="orion_tpu_torch/csrc/flash_bwd.cu",
                          replaces="orion_tpu/ops/pallas/flash_attention.py:274"),
    "paged_decode_int8": dict(route="cuda", source="orion_tpu_torch/csrc/paged_decode.cu",
                              replaces="orion_tpu/ops/pallas/paged_attention.py:305"),
    "paged_prefill": dict(route="cuda", source="orion_tpu_torch/csrc/paged_prefill.cu",
                          replaces="orion_tpu/ops/pallas/paged_flash_prefill.py:396"),
    "paged_prefill_int8": dict(route="cuda", source="orion_tpu_torch/csrc/paged_prefill.cu",
                               replaces="orion_tpu/ops/pallas/paged_flash_prefill.py:396"),
    "ragged_verify": dict(route="cuda", source="orion_tpu_torch/csrc/ragged_verify.cu",
                          replaces="orion_tpu/ops/pallas/ragged_paged_attention.py:483"),
    "ragged_verify_int8": dict(route="cuda", source="orion_tpu_torch/csrc/ragged_verify.cu",
                               replaces="orion_tpu/ops/pallas/ragged_paged_attention.py:483"),
    # The TPU kernel carries the softmax state across its sequential page
    # axis; the tensor-core K9 splits a long history across blocks and
    # merges the splits' states here.
    "paged_prefill_merge": dict(route="cuda", source="orion_tpu_torch/csrc/paged_prefill.cu",
                                replaces="orion_tpu/ops/pallas/paged_flash_prefill.py:396"),
    # The same for K4: the tensor-core K4 splits a slot's page walk across
    # blocks and merges the splits' states here.
    "paged_decode_merge": dict(route="cuda", source="orion_tpu_torch/csrc/paged_decode.cu",
                               replaces="orion_tpu/ops/pallas/paged_attention.py:305"),
    # The same for K10: the tensor-core K10 splits a slot's page walk
    # across blocks and merges the splits' states, per query row, here.
    "ragged_verify_merge": dict(route="cuda", source="orion_tpu_torch/csrc/ragged_verify.cu",
                                replaces="orion_tpu/ops/pallas/ragged_paged_attention.py:483"),
    # The same for K3's positions branch: the bf16 kernel splits a block's
    # live key steps across blocks and merges the splits' states here.
    "flash_fwd_pos_merge": dict(route="cuda", source="orion_tpu_torch/csrc/flash_fwd.cu",
                                replaces="orion_tpu/ops/pallas/flash_attention.py:178"),
}

# Shapes of the kernels phase (the serving path's at llama3-8b-infer).
K1_ROWS, D_MODEL = 4 * 2048, 4096
B_PRE, S_PRE, N_HEADS, N_KV, HEAD = 4, 2048, 32, 8, 128
PRE_LENS = (2048, 1500, 700, 1)
B_DEC, PSZ, NUM_PAGES, N_LAYERS = 32, 64, 2048, 32
SCALE_LANES = 128
# K9 at the chunked serve's shapes: 4 chunk rows of 256 (4 pages of 64)
# resuming at these page-aligned starts (walk padded to 128 prefix pages).
K9_S, K9_STARTS, K9_LENS = 256, (0, 1024, 4096, 7936), (256, 256, 100, 256)
# K10 at K4's slots and contexts: W = speculate_tokens + 1 = 5 queries per
# slot starting at K4's positions; real queries cycle 5, 3, 1; slots 0 and
# 1 are pad rows (all-zero table, one query) and the last slot sits at the
# context edge (start 8189: two of its five tokens fall past the table).
K10_W = 5
# K10 at the speculative serve's verify batch: 8 slots at contexts 100-1064
# (its prompts of 100-1000 tokens plus 64 new ones), W = 5, every draft real.
K10_SERVE_STARTS = [int(100 + 964 * i / 7) for i in range(8)]
# Shapes of the training path (llama-1b-bench: batch 8 x 2048 tokens,
# d_model 2048, 16 heads, 8 kv heads, head_dim 128).
T_B, T_S, T_D, T_N, T_K = 8, 2048, 2048, 16, 8
TRAIN_STEPS = 6

# train_parity: tiny-llama in float32 on cuda against cpu. The first
# step's loss to 1e-5 and its gradients to 2e-6 absolute + 1e-4 relative
# (float32 sums in another order, as the CPU tests against the JAX
# package); the losses of later steps to 1e-4: AdamW's first updates are
# about sign(g) * lr, so a gradient element near 0 whose sign differs
# between the two devices moves its parameter by 2 lr.
TRAIN_TOL = {"loss_step1": 1e-5, "grads_step1": (2e-6, 1e-4), "loss": 1e-4}
TRAIN_PARITY_OVERRIDES = [
    "train.num_steps=3", "train.log_interval=1000", "data.packed=true",
    "optimizer.warmup_steps=1",
]
ROBUST_KEYS = ("shed_requests", "shed_context_requests", "expired_requests",
               "cancelled_requests", "quarantined_requests", "dispatch_faults",
               "dispatch_retries", "dispatch_fallbacks", "failed_steps", "stalled_steps",
               "pool_faults")
SERVE_KERNELS = ("rmsnorm_fwd", "rope_fwd", "flash_fwd", "paged_decode", "paged_decode_merge")
SERVE_CHUNKED_KERNELS = ("rmsnorm_fwd", "rope_fwd", "flash_fwd", "paged_decode_int8",
                         "paged_decode_merge", "paged_prefill_int8", "paged_prefill_merge")
SERVE_CHUNKED_OVERRIDES = ["inference.kv_quant=int8", "inference.prefix_cache=true",
                           "inference.chunked_prefill=true"]
TRAIN_KERNELS = ("rmsnorm_fwd", "rope_fwd", "flash_fwd", "rmsnorm_bwd", "rope_bwd",
                 "flash_dq", "flash_dkv")


def emit(obj) -> None:
    """Print one JSON line, and append it to chiprun_out/chip_smoke.jsonl
    (the whole run's lines, where a caller keeps only the end of the
    output)."""
    line = json.dumps(obj)
    print(line, flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.jsonl"), "a") as f:
        f.write(line + "\n")


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

    return {torch.bfloat16: torch.int16, torch.float32: torch.int32,
            torch.int8: torch.int8}[t.dtype]


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


def require_dscale_close(dtype_name, a, b) -> float:
    """K5's scale gradient a against the plain b (TOL["rmsnorm_dscale"] by
    the scale's dtype): |a - b| within a share of b's RMS plus n bf16 ulps
    of each b (one bf16 ulp of b = m 2^e, m in [0.5, 1), is 2^(e-8)).
    Returns max |a - b| / RMS(b)."""
    import torch

    of_rms, ulps = TOL["rmsnorm_dscale"][dtype_name]
    x, y = a.float(), b.float()
    if not torch.isfinite(x).all():
        raise AssertionError(f"rmsnorm_dscale {dtype_name}: non-finite kernel output")
    rms = float(y.square().mean().sqrt())
    lim = torch.full_like(y, of_rms * rms)
    if ulps:
        lim += ulps * torch.ldexp(torch.ones_like(y), torch.frexp(y).exponent - 8)
    err = (x - y).abs()
    if not bool((err <= lim).all()):
        raise AssertionError(f"rmsnorm_dscale {dtype_name}: max |kernel - plain| = "
                             f"{float(err.max())} over {of_rms} RMS + {ulps} ulp")
    return float(err.max()) / max(rms, 1e-30)


def check_dscale(x, s, g, part, ds) -> float:
    """K5's scale gradient at (x, s, g): the float32 sum of its partial rows
    ``part`` against the plain float32 sum (TOL["rmsnorm_dscale"]
    ["float32"], for either scale dtype) and, beside a bf16 scale, the cast
    result ``ds`` against the plain one's cast (["bfloat16"]). Returns the
    float32 sum's max |a - b| / RMS(b)."""
    import torch

    from orion_tpu_torch import ops

    err = require_dscale_close("float32", part.sum(dim=0),
                               ops.rmsnorm_bwd_plain(x, s.float(), g, 1e-5)[1])
    if s.dtype != torch.float32:
        require_dscale_close(str(s.dtype).split(".")[-1], ds,
                             ops.rmsnorm_bwd_plain(x, s, g, 1e-5)[1])
    return err


def require_slots_close(name, dtype_name, a, b, rows) -> float:
    """The per-row check (K4_SLOT_REL) over ``rows`` of a and b: K4's live
    slots ([B] mask of [B, N, H]) or K10's real query rows ([B, W] mask
    of [B, W, N, H]). Returns the largest row's max |a - b| / RMS(b)."""
    x, y = a.float()[rows], b.float()[rows]
    rel = float(((x - y).abs().amax(dim=(1, 2)) / y.pow(2).mean(dim=(1, 2)).sqrt()).max())
    if not rel <= K4_SLOT_REL:
        raise AssertionError(f"{name} {dtype_name}: a row's max |kernel - plain| is {rel:.4g} "
                             f"of its RMS, over {K4_SLOT_REL}")
    return rel


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


def rand_pools(dtype, gen, rows, K, psz, H, quant):
    """K/V pools [rows, K, psz, H] of standard normal values in ``dtype``,
    or the int8 pools ``quantize_kv`` makes of such values, with float32
    scale pools [rows, K, SCALE_LANES] as a dict ``scales`` (empty for a
    pool of ``dtype``); scale lanes past the page hold random garbage."""
    import torch

    from orion_tpu_torch.ops import quantize_kv

    if not quant:
        return (*(torch.randn(rows, K, psz, H, generator=gen, device="cuda").to(dtype)
                  for _ in range(2)), {})
    pools, scales = [], []
    for _ in range(2):
        pool = torch.empty(rows, K, psz, H, dtype=torch.int8, device="cuda")
        scale = torch.rand(rows, K, SCALE_LANES, generator=gen, device="cuda")
        for r0 in range(0, rows, 2048):
            n = min(2048, rows - r0)
            pool[r0:r0 + n], scale[r0:r0 + n, :, :psz] = quantize_kv(
                torch.randn(n, K, psz, H, generator=gen, device="cuda"))
        pools.append(pool)
        scales.append(scale)
    return (*pools, {"k_scale": scales[0], "v_scale": scales[1]})


K4_LAST_POS = [0, 0] + [int(8191 * ((b + 1) / B_DEC) ** 2) for b in range(2, B_DEC)]
# The plain serve's decode batch: 16 live slots at contexts 100-2064 (its
# prompts of 100-2000 tokens plus 64 new ones), 16 idle.
K4_SERVE_LAST_POS = [int(99 + 1964 * i / 15) for i in range(16)] + [0] * 16


def k4_inputs(dtype, gen, quant=False, last_pos=K4_LAST_POS):
    """32 slots over the full preset pool at layer 31: slots with last_pos
    0 idle (all-zero page table, scratch page 0; slots 0 and 1 by
    default), the rest with ragged contexts (up to 8191 by default) on
    distinct pages. Returns the pools' scales last."""
    import torch

    P = 8192 // PSZ
    rows = N_LAYERS * NUM_PAGES
    k_pool, v_pool, scales = rand_pools(dtype, gen, rows, N_KV, PSZ, HEAD, quant)
    perm = torch.randperm(NUM_PAGES - 1, generator=gen, device="cuda") + 1
    table = torch.zeros(B_DEC, P, dtype=torch.int32, device="cuda")
    used = 0
    for b in range(B_DEC):
        if last_pos[b] == 0:
            continue
        n = last_pos[b] // PSZ + 1
        table[b, :n] = perm[used:used + n].to(torch.int32)
        used += n
    assert used <= NUM_PAGES - 1, used
    q = torch.randn(B_DEC, N_HEADS, HEAD, generator=gen, device="cuda").to(dtype)
    kn = torch.randn(B_DEC, N_KV, HEAD, generator=gen, device="cuda").to(dtype)
    vn = torch.randn(B_DEC, N_KV, HEAD, generator=gen, device="cuda").to(dtype)
    lp = torch.tensor(last_pos, dtype=torch.int32, device="cuda")
    return q, k_pool, v_pool, table, lp, kn, vn, (N_LAYERS - 1) * NUM_PAGES, scales


def k9_inputs(dtype, gen, quant, *, B=4, N=N_HEADS, K=N_KV, H=HEAD, psz=PSZ, S=K9_S,
              starts=K9_STARTS, lens=K9_LENS, NP=NUM_PAGES, L=N_LAYERS):
    """Chunk rows over a pool of L layers x NP pages at the last layer: row
    b resumes at ``starts[b]`` over history pages and writes its S // psz
    chunk pages, all distinct; a row of length 1 with start 0 is a pad row
    (all-zero walk, writes scratch page 0). The walk's prefix half is
    padded to a power of two, as the engine pads it."""
    import torch

    NC = S // psz
    n_pre = [st // psz for st in starts]
    P_pre = 1 << (max(n_pre) - 1).bit_length() if max(n_pre) else 0
    kp, vp, scales = rand_pools(dtype, gen, L * NP, K, psz, H, quant)
    pad = [st == 0 and n == 1 for st, n in zip(starts, lens)]
    need = sum(n + NC for n, p in zip(n_pre, pad) if not p)
    assert need <= NP - 1, need
    ids = (torch.randperm(NP - 1, generator=gen, device="cuda")[:need] + 1).tolist()
    walk = torch.zeros(B, P_pre + NC, dtype=torch.int32)
    for b in range(B):
        if not pad[b]:
            walk[b, :n_pre[b]] = torch.tensor(ids[:n_pre[b]], dtype=torch.int32)
            walk[b, P_pre:] = torch.tensor(ids[n_pre[b]:n_pre[b] + NC], dtype=torch.int32)
            ids = ids[n_pre[b] + NC:]

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    q, kn, vn = rnd(B, S, N, H), rnd(B, S, K, H), rnd(B, S, K, H)
    dev = dict(dtype=torch.int32, device="cuda")
    return (q, kp, vp, walk.to("cuda"), torch.tensor(starts, **dev), torch.tensor(lens, **dev),
            kn, vn, (L - 1) * NP, scales, P_pre)


def t_norm_inputs(dtype, gen):
    """K1/K5 at the training path's rows: x, scale and a cotangent."""
    import torch

    x, s = (t.to(dtype) for t in (
        torch.randn(T_B * T_S, T_D, generator=gen, device="cuda"),
        1.0 + 0.1 * torch.randn(T_D, generator=gen, device="cuda")))
    g = torch.randn(T_B * T_S, T_D, generator=gen, device="cuda").to(dtype)
    return x, s, g


def t_attn_inputs(dtype, gen, B=T_B, S=T_S, N=T_N, K=T_K, H=HEAD, off=0):
    """q [B, S, N, H], k/v [B, S+off, K, H] and a cotangent for the output."""
    import torch

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    return rnd(B, S, N, H), rnd(B, S + off, K, H), rnd(B, S + off, K, H), rnd(B, S, N, H)


def plain_grads(fn, inputs, cotangent):
    """Autograd of a plain version: d(fn(*inputs)) / d inputs for ``cotangent``."""
    import torch

    leaves = [t.detach().requires_grad_() for t in inputs]
    return torch.autograd.grad(fn(*leaves), leaves, cotangent)


def check_flash_train(dn, q, k, v, do, kw, q_rows=None, kv_rows=None):
    """K3 (output and lse), K7 and K8 against the plain attention and its
    autograd; ``q_rows`` / ``kv_rows`` select the compared rows where
    padding rows hold garbage. Returns max errors by kernel."""
    import torch

    from orion_tpu_torch import ops

    out, lse = ops.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    dq, dk, dv = ops.flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
    # Every row, padding included: a padding row's gradients feed the
    # weight gradients, so K3, K7 and K8 must count the same pairs (an lse
    # that missed a pair K7/K8 count makes exp(z - lse) overflow).
    for name, t in (("dq", dq), ("dk", dk), ("dv", dv)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"flash backward {dn}: non-finite {name} (all rows)")
    plain_kw = {key: val for key, val in kw.items() if key != "seg_pad_zero"}
    lse_rows = None if q_rows is None else q_rows[:, None].expand(-1, q.shape[2], -1)
    errs = {
        "flash_fwd": require_close("flash_fwd", dn, out,
                                   ops.attention_plain(q, k, v, **plain_kw), rows=q_rows),
        "flash_lse": require_close("flash_lse", dn, lse,
                                   ops.attention_lse_plain(q, k, **plain_kw), rows=lse_rows),
    }
    pq, pk, pv = plain_grads(lambda a, b, c: ops.attention_plain(a, b, c, **plain_kw),
                             [q, k, v], do)
    errs["flash_dq"] = require_close("flash_dq", dn, dq, pq, rows=q_rows)
    errs["flash_dkv"] = max(require_close("flash_dkv", dn, dk, pk, rows=kv_rows),
                            require_close("flash_dkv", dn, dv, pv, rows=kv_rows))
    return errs


def check_train_kernels(dtype, gen):
    """K1/K5, K2/K6 and K3 (with lse)/K7/K8 at the training path's shapes
    against their plain versions (the backward ones: autograd of the plain
    forward). Returns max errors by kernel."""
    import torch

    from orion_tpu_torch import ops

    dn = str(dtype).split(".")[-1]
    x, s, g = t_norm_inputs(dtype, gen)
    errs = {}
    # The scale in x's dtype, then (bf16) the training path's float32 master
    # scale beside bf16 rows.
    for scale in (s, s.float()) if dtype == torch.bfloat16 else (s,):
        e1 = require_close("rmsnorm_fwd", dn, ops.rmsnorm_cuda(x, scale, 1e-5),
                           ops.rmsnorm_plain(x, scale, 1e-5))
        dx, ds = ops.rmsnorm_bwd_cuda(x, scale, g, 1e-5, True)
        pdx = plain_grads(lambda t: ops.rmsnorm_plain(t, scale, 1e-5), [x], g)[0]
        e5 = require_close("rmsnorm_bwd", dn, dx, pdx)
        errs["rmsnorm_fwd"] = max(errs.get("rmsnorm_fwd", 0.0), e1)
        errs["rmsnorm_bwd"] = max(errs.get("rmsnorm_bwd", 0.0), e5)
        key = "rmsnorm_dscale" if scale.dtype == dtype else "rmsnorm_dscale_f32_scale"
        errs[key] = check_dscale(x, scale, g, ops.rmsnorm_bwd_partials(
            x, scale, g, 1e-5, True)[1], ds)
        del dx, pdx
    del x, g
    q, k, _, gq = t_attn_inputs(dtype, gen)
    pos = torch.arange(T_S, device="cuda", dtype=torch.int32).expand(T_B, T_S)
    gk = torch.randn(k.shape, generator=gen, device="cuda").to(dtype)
    errs["rope_fwd"] = max(
        require_close("rope_fwd", dn, ops.rope_triton(t, pos, 500000.0),
                      ops.rope_plain(t, pos, 500000.0)) for t in (q, k))
    errs["rope_bwd"] = max(
        require_close("rope_bwd", dn, ops.rope_bwd_triton(gt, pos, 500000.0),
                      plain_grads(lambda a: ops.rope_plain(a, pos, 500000.0), [t], gt)[0])
        for t, gt in ((q, gq), (k, gk)))
    del q, k, gq, gk
    torch.cuda.empty_cache()
    errs.update(check_flash_train(dn, *t_attn_inputs(dtype, gen), dict(causal=True)))
    torch.cuda.empty_cache()
    return errs


def packed_segments(S, kind):
    """[2, S] int32 segment ids of packed rows, segment 0 = padding:
    ``packed`` two documents and a padding tail from S - 40 (row 1: one
    document, padding from S - 7); ``packed_half`` the same with the
    second document ending at S - 60; ``half_step`` one document ending at
    150 (S > 192), so the 32-key step 128.. holds real and padding keys,
    the step 160.. only padding, and the 128-row q tile 128.. one live and
    one all-padding 64-row tile; ``boundaries`` three documents ending at
    S/5, 2S/3 and S - 20 (row 1: two, at 64 and S - 7), boundaries inside
    32-key steps between long runs of one segment."""
    import torch

    seg = torch.zeros(2, S, dtype=torch.int32, device="cuda")
    ends = {"packed": ([S // 2, S - 40], [S - 7]),
            "packed_half": ([S // 3, S - 60], [S - 7]),
            "half_step": ([150], [S - 7]),
            "boundaries": ([S // 5, 2 * S // 3, S - 20], [64, S - 7])}[kind]
    for row, cuts in enumerate(ends):
        lo = 0
        for i, hi in enumerate(cuts):
            seg[row, lo:hi] = i + 1
            lo = hi
    return seg


def train_variants(gen):
    """K3 lse / K7 / K8 off the training path's shapes: ragged segments
    under seg_pad_zero, a window, softcaps, q_offset, rows that attend
    nothing, no causal mask, head_dim 16-256; f32 and bf16. The rows after
    the first eleven stress the 128-row, 32-key steps of the bf16 K3/K7:
    a step with real and padding keys before an all-padding one under a
    live q tile, the window's edge and the diagonal inside one step, and
    segment boundaries inside steps (the segment-uniform fast path taken
    and refused), at head_dim 16, 128 and 256."""
    import torch

    out = []
    for H, N, K, S, causal, window, cap, off, segs in (
        (64, 8, 2, 300, True, 64, 30.0, 0, "packed"),
        (32, 4, 2, 77, True, None, 50.0, 0, "packed"),
        (128, 4, 4, 200, True, None, None, 5, None),
        (256, 2, 1, 129, True, 17, None, 0, None),
        (128, 4, 2, 96, True, None, None, 0, "masked_rows"),
        (16, 4, 1, 70, False, None, None, 0, None),
        # K8's 64-key tiles against K3's 64x32 ones: padding from S - 40
        # and S - 7 (S = 460, no multiple of 64), all-padding K3 tiles
        # (row 0's q tile 448.. and key tile 448..479); padding from S - 60
        # leaves the key tile 384..447 with one live and one all-padding
        # 32-key half.
        (128, 4, 2, 460, True, None, None, 0, "packed"),
        (128, 4, 2, 460, True, None, 30.0, 0, "packed_half"),
        # Fewer keys than one of K8's tiles.
        (64, 4, 2, 40, True, None, None, 0, "packed"),
        (128, 4, 4, 30, True, None, None, 5, None),
        (32, 4, 2, 20, False, None, None, 0, None),
        (128, 4, 2, 230, True, None, None, 0, "half_step"),
        (16, 4, 2, 230, True, None, None, 0, "half_step"),
        (128, 8, 2, 512, True, None, None, 0, "boundaries"),
        (256, 2, 1, 300, True, None, 30.0, 0, "boundaries"),
        (16, 4, 2, 200, True, 40, None, 0, "boundaries"),
        (128, 4, 2, 300, True, 20, None, 0, None),
        (64, 4, 2, 260, True, 40, 30.0, 3, None),
    ):
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            q, k, v, do = t_attn_inputs(dtype, gen, B=2, S=S, N=N, K=K, H=H, off=off)
            kw = dict(causal=causal, logit_softcap=cap, window=window, q_offset=off)
            q_rows = kv_rows = None
            if segs in ("packed", "packed_half", "half_step", "boundaries"):
                seg = packed_segments(S, segs)
                kw.update(q_segment_ids=seg, kv_segment_ids=seg, seg_pad_zero=True)
                q_rows = kv_rows = seg > 0
            elif segs == "masked_rows":
                # The second half of the queries attends nothing (q segment
                # 2 against kv segment 3): zeros out, no NaN in any grad.
                qs = torch.ones(2, S, dtype=torch.int32, device="cuda")
                ks = qs.clone()
                qs[:, S // 2:], ks[:, S // 2:] = 2, 3
                kw.update(q_segment_ids=qs, kv_segment_ids=ks)
            errs = check_flash_train(dn, q, k, v, do, kw, q_rows=q_rows, kv_rows=kv_rows)
            out.append({"H": H, "N": N, "K": K, "S": S, "causal": causal, "window": window,
                        "softcap": cap, "q_offset": off, "segments": segs, "dtype": dn,
                        **errs})
    return out


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


def run_both(cuda, plain, pools, wrows, args, kw):
    """Run a kernel that writes rows ``wrows`` of ``pools`` in place, then
    its plain version from the same pool bytes. Returns both outputs, the
    written rows of each run, and the rows as they were before."""
    import torch

    before = [t[wrows].clone() for t in pools]
    out_k = cuda(*args, **kw)[0]
    torch.cuda.synchronize()
    rows_k = [t[wrows].clone() for t in pools]
    for t, b in zip(pools, before):
        t[wrows] = b
    out_p = plain(*args, **kw)[0]
    return out_k, out_p, rows_k, [t[wrows] for t in pools], before


def require_bytes_equal(what, got, want):
    import torch

    for a, b in zip(got, want):
        if not torch.equal(bits(a), bits(b)):
            raise AssertionError(f"{what}: written pool rows differ from the plain version")


def check_k4(dtype, gen, quant=False):
    """K4 kernel vs plain: outputs of the live slots (within TOL, and each
    slot within K4_SLOT_REL of its RMS), and the written pool rows (and
    scale rows, int8) byte for byte."""
    import torch

    from orion_tpu_torch import ops

    name = "paged_decode_int8" if quant else "paged_decode"
    cuda = ops.paged_attention_int8_cuda if quant else ops.paged_attention_cuda
    q, kp, vp, table, lp, kn, vn, base, scales = k4_inputs(dtype, gen, quant)
    live = torch.arange(B_DEC, device="cuda") >= 2
    wrows = base + table[torch.arange(B_DEC, device="cuda"), lp // PSZ].long()
    wrows = wrows[live]
    pools = [kp, vp, *scales.values()]
    out_k, out_p, rows_k, rows_p, _ = run_both(
        cuda, ops.paged_attention_plain, pools, wrows, (q, kp, vp, table, lp),
        dict(layer_base=base, k_new=kn, v_new=vn, **scales))
    require_bytes_equal(name, rows_k, rows_p)
    col = (lp % PSZ).long()[live]
    want = ops.quantize_kv(kn[live])[0] if quant else kn[live]
    got = rows_k[0][torch.arange(len(col), device="cuda"), :, col]
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: the new token's K is not in its pool slot")
    dn = str(dtype).split(".")[-1]
    err = require_close(name, dn, out_k, out_p, rows=live)
    emit({"phase": "kernels", "kernel": name, "dtype": dn,
          "slot_rel_err": require_slots_close(name, dn, out_k, out_p, live),
          "slot_rel_bound": K4_SLOT_REL})
    del q, kp, vp, pools, scales
    return err


def check_k4_deterministic(gen, quant):
    """Two launches of the bf16 K4 on the same inputs: bitwise-equal outputs
    (live slots) and pools. The second launch writes the same token bits
    over the first's, so its inputs are the first's."""
    import torch

    from orion_tpu_torch import ops

    cuda = ops.paged_attention_int8_cuda if quant else ops.paged_attention_cuda
    q, kp, vp, table, lp, kn, vn, base, scales = k4_inputs(torch.bfloat16, gen, quant)
    kw = dict(layer_base=base, k_new=kn, v_new=vn, **scales)
    first = cuda(q, kp, vp, table, lp, **kw)[0]
    pools = [t.clone() for t in (kp, vp, *scales.values())]
    second = cuda(q, kp, vp, table, lp, **kw)[0]
    torch.cuda.synchronize()
    live = torch.arange(B_DEC, device="cuda") >= 2
    keep = torch.ones(kp.shape[0], dtype=torch.bool, device="cuda")
    keep[base] = False   # scratch page 0: the idle slots' writes, in no order
    if not (torch.equal(bits(first[live]), bits(second[live]))
            and all(torch.equal(bits(a[keep]), bits(b[keep]))
                    for a, b in zip(pools, (kp, vp, *scales.values())))):
        raise AssertionError(f"paged_decode{'_int8' if quant else ''}: two launches differ")
    del q, kp, vp, pools, scales


def decode_merge_inputs(gen):
    """K4's split partials at the kernels phase's K4 shapes (32 slots, the
    table's 128 pages in splits of DECODE_SPLIT_PAGES): O standard normal,
    m in (-4, 4), l in (0.5, 4.5), and in every slot one head whose first
    active split attended nothing (m NEG_INF, l 0, O 0)."""
    import torch

    from orion_tpu_torch.ops.paged_attention import decode_n_splits

    n_sp = decode_n_splits(8192 // PSZ)
    o = torch.randn(n_sp, B_DEC, N_HEADS, HEAD, generator=gen, device="cuda")
    ml = torch.rand(n_sp, B_DEC, N_HEADS, 2, generator=gen, device="cuda")
    ml[..., 0] = 8 * ml[..., 0] - 4
    ml[..., 1] = 4 * ml[..., 1] + 0.5
    ml[0, :, 0, 0], ml[0, :, 0, 1], o[0, :, 0] = -1e30, 0.0, 0.0
    lp = torch.tensor(K4_LAST_POS, dtype=torch.int32, device="cuda")
    out = torch.randn(B_DEC, N_HEADS, HEAD, generator=gen, device="cuda").to(torch.bfloat16)
    return o, ml, lp, out, dict(page_size=PSZ)


def check_decode_merge(gen):
    """K4's merge kernel against its plain version: the merged slots, and
    every other slot of ``out`` untouched."""
    import torch

    from orion_tpu_torch import ops
    from orion_tpu_torch.ops.paged_attention import decode_active_splits

    o, ml, lp, out, kw = decode_merge_inputs(gen)
    want = ops.paged_decode_merge_plain(o, ml, lp, out.clone(), **kw)
    before = out.clone()
    got = ops.paged_decode_merge_cuda(o, ml, lp, out, **kw)
    torch.cuda.synchronize()
    merged = torch.tensor([len(decode_active_splits(x, **kw)) > 1 for x in lp.tolist()],
                          device="cuda")
    if not torch.equal(bits(got[~merged]), bits(before[~merged])):
        raise AssertionError("paged_decode_merge: a slot with one split changed")
    return require_close("paged_decode_merge", "bfloat16", got, want)


def check_k9(dtype, gen, quant, **shape):
    """K9 kernel vs plain: outputs of the real queries; the chunk pages
    (and their scale rows) byte for byte, scratch page 0 excluded; history
    pages and scale lanes past the page untouched."""
    import torch

    from orion_tpu_torch import ops

    name = "paged_prefill_int8" if quant else "paged_prefill"
    cuda = ops.paged_flash_prefill_int8_cuda if quant else ops.paged_flash_prefill_cuda
    kw = {key: shape.pop(key) for key in ("window", "logit_softcap") if key in shape}
    q, kp, vp, walk, start, lens, kn, vn, base, scales, P_pre = k9_inputs(
        dtype, gen, quant, **shape)
    psz = kp.shape[2]
    walk_l = walk.long()
    wrows = base + walk_l[:, P_pre:].reshape(-1)
    hist = walk_l[:, :P_pre]
    hrows = base + hist[hist > 0]
    pools = [kp, vp, *scales.values()]
    hist_before = [t[hrows].clone() for t in pools]
    out_k, out_p, rows_k, rows_p, before = run_both(
        cuda, ops.paged_flash_prefill_plain, pools, wrows,
        (q, kp, vp, walk, start, lens, kn, vn),
        dict(n_prefix_pages=P_pre, layer_base=base, **scales, **kw))
    real_w = wrows != base      # pad rows write scratch page 0, in no fixed order
    require_bytes_equal(name, [r[real_w] for r in rows_k], [r[real_w] for r in rows_p])
    if not all(torch.equal(bits(t[hrows]), bits(h)) for t, h in zip(pools, hist_before)):
        raise AssertionError(f"{name}: history pages changed")
    if quant and not all(torch.equal(r[real_w][..., psz:], b[real_w][..., psz:])
                         for r, b in zip(rows_k[2:], before[2:])):
        raise AssertionError(f"{name}: scale lanes past the page changed")
    real = torch.arange(q.shape[1], device="cuda")[None] < lens[:, None]
    err = require_close(name, str(dtype).split(".")[-1], out_k, out_p, rows=real)
    del q, kp, vp, pools, scales, hist_before, before
    return err


def merge_inputs(gen, *, B=4, S=K9_S, N=N_HEADS, H=HEAD, psz=PSZ, starts=K9_STARTS):
    """K9's split partials at the kernels phase's shapes (the walk padded
    to 128 prefix pages: 8 splits; rows at starts 0/1024/4096/7936 merge
    1/1/4/8 of them): O standard normal, m in (-4, 4), l in (0.5, 4.5),
    and in every merged row one query per head whose first split attended
    nothing (m NEG_INF, l 0, O 0)."""
    import torch

    from orion_tpu_torch.ops.paged_flash_prefill import n_splits

    P_pre = 1 << (max(st // psz for st in starts) - 1).bit_length()
    n_sp = n_splits(P_pre)
    o = torch.randn(n_sp, B, S, N, H, generator=gen, device="cuda")
    ml = torch.rand(n_sp, B, S, N, 2, generator=gen, device="cuda")
    ml[..., 0] = 8 * ml[..., 0] - 4
    ml[..., 1] = 4 * ml[..., 1] + 0.5
    ml[0, :, 0, :, 0], ml[0, :, 0, :, 1], o[0, :, 0] = -1e30, 0.0, 0.0
    start = torch.tensor(starts, dtype=torch.int32, device="cuda")
    out = torch.randn(B, S, N, H, generator=gen, device="cuda").to(torch.bfloat16)
    return o, ml, start, out, dict(n_prefix_pages=P_pre, page_size=psz)


def check_merge(gen):
    """K9's merge kernel against its plain version: the merged rows, and
    every other row of ``out`` untouched."""
    import torch

    from orion_tpu_torch import ops

    o, ml, start, out, kw = merge_inputs(gen)
    want = ops.paged_prefill_merge_plain(o, ml, start, out.clone(), **kw)
    before = out.clone()
    got = ops.paged_prefill_merge_cuda(o, ml, start, out, **kw)
    torch.cuda.synchronize()
    merged = torch.tensor([n > 1 for n in merged_rows(start, kw)], device="cuda")
    if not torch.equal(bits(got[~merged]), bits(before[~merged])):
        raise AssertionError("paged_prefill_merge: a row with one split changed")
    return require_close("paged_prefill_merge", "bfloat16", got, want)


def merged_rows(start, kw):
    """Active splits of each row (more than one: the merge writes it)."""
    from orion_tpu_torch.ops.paged_flash_prefill import active_splits

    return [active_splits(int(s), page_size=kw["page_size"],
                          n_prefix_pages=kw["n_prefix_pages"]) for s in start.tolist()]


def k10_main_shape():
    """K10 at the serve's width: 32 slots at K4's contexts (see K10_W)."""
    starts = [0, 0] + [int(8191 * ((b + 1) / B_DEC) ** 2) for b in range(2, B_DEC)]
    starts[-1] = 8189
    lens = [1, 1] + [(5, 3, 1)[b % 3] for b in range(2, B_DEC)]
    lens[-1] = K10_W
    return dict(starts=starts, lens=lens, pad=[True, True] + [False] * (B_DEC - 2))


def k10_serve_shape():
    """K10 at the speculative serve's verify batch (K10_SERVE_STARTS)."""
    n = len(K10_SERVE_STARTS)
    return dict(starts=list(K10_SERVE_STARTS), lens=[K10_W] * n, pad=[False] * n)


def k10_small_shape(W, psz, P, **heads):
    """Five rows on a two-layer pool of 64 pages: a pad row, a row
    straddling a page boundary, a half-full row, a single query mid-table
    and a row at the context edge (its last tokens fall past the table)."""
    cap = P * psz
    return dict(starts=[0, psz - 3, 2 * psz, cap // 2 + 1, cap - max(W - 2, 1)],
                lens=[1, W, max(W // 2, 1), 1, W], pad=[True] + [False] * 4,
                W=W, psz=psz, P=P, NP=64, L=2, **heads)


def k10_inputs(dtype, gen, quant, *, starts, lens, pad, W=K10_W, N=N_HEADS, K=N_KV, H=HEAD,
               psz=PSZ, P=8192 // PSZ, NP=NUM_PAGES, L=N_LAYERS, layer=None):
    """Verify rows over a pool of L layers x NP pages at ``layer`` (the
    last by default): row b's W queries start at ``starts[b]``, ``lens[b]``
    of them real, on distinct pages through its last written position;
    pad rows have an all-zero table (scratch page 0)."""
    import torch

    B = len(starts)
    kp, vp, scales = rand_pools(dtype, gen, L * NP, K, psz, H, quant)
    n_pages = [0 if pad[b] else min(starts[b] + lens[b] - 1, P * psz - 1) // psz + 1
               for b in range(B)]
    assert sum(n_pages) <= NP - 1, sum(n_pages)
    ids = (torch.randperm(NP - 1, generator=gen, device="cuda") + 1).to(torch.int32)
    table = torch.zeros(B, P, dtype=torch.int32, device="cuda")
    used = 0
    for b, n in enumerate(n_pages):
        table[b, :n] = ids[used:used + n]
        used += n

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    dev = dict(dtype=torch.int32, device="cuda")
    layer = L - 1 if layer is None else layer
    return (rnd(B, W, N, H), kp, vp, table, torch.tensor(starts, **dev),
            torch.tensor(lens, **dev), rnd(B, W, K, H), rnd(B, W, K, H), layer * NP, scales)


def tree_arrays(B, W, parents):
    """[B, W] depths and ancestor words of one tree for every row; columns
    past the tree chain-shaped (the engine's padding)."""
    import torch

    from orion_tpu_torch.infer.spec_decode import DraftTree

    t = DraftTree(tokens=[0] * len(parents), parents=list(parents))
    n = len(parents) + 1
    depths = list(t.depths()) + list(range(n, W))
    words = list(t.mask_words()) + [(1 << (j + 1)) - 1 for j in range(n, W)]
    dev = dict(dtype=torch.int32, device="cuda")
    return torch.tensor([depths] * B, **dev), torch.tensor([words] * B, **dev)


def check_k10(dtype, gen, quant, shape=None, *, tree=None, **kw):
    """K10 kernel vs plain: outputs of the real queries; the written pages
    and scale columns byte for byte (scratch page 0 excluded); every other
    row of the layer untouched by both. ``tree`` is a parent list (a token
    tree for every row); ``kw`` adds window / logit_softcap."""
    import torch

    from orion_tpu_torch import ops

    name = "ragged_verify_int8" if quant else "ragged_verify"
    cuda = ops.ragged_verify_int8_cuda if quant else ops.ragged_verify_cuda
    shape = dict(shape or k10_main_shape())
    q, kp, vp, table, start, lens, kn, vn, base, scales = k10_inputs(dtype, gen, quant, **shape)
    B, W = q.shape[:2]
    NP = shape.get("NP", NUM_PAGES)
    if tree is not None:
        kw["depths"], kw["tree_mask"] = tree_arrays(B, W, tree)
    wrows = torch.unique(base + table[table > 0].long())
    pools = [kp, vp, *scales.values()]
    region = [t[base:base + NP].clone() for t in pools]
    out_k, out_p, rows_k, rows_p, _ = run_both(
        cuda, ops.ragged_paged_attention_plain, pools, wrows,
        (q, kp, vp, table, start, lens), dict(layer_base=base, k_new=kn, v_new=vn,
                                               **scales, **kw))
    require_bytes_equal(name, rows_k, rows_p)
    other = torch.ones(NP, dtype=torch.bool, device="cuda")
    other[0] = False
    other[wrows - base] = False
    for t, r in zip(pools, region):
        if not torch.equal(bits(t[base:base + NP][other]), bits(r[other])):
            raise AssertionError(f"{name}: rows it does not own changed")
    real = torch.arange(W, device="cuda")[None] < lens[:, None]
    real[torch.tensor(shape["pad"], device="cuda")] = False
    dn = str(dtype).split(".")[-1]
    err = require_close(name, dn, out_k, out_p, rows=real)
    rel = require_slots_close(name, dn, out_k, out_p, real)
    del q, kp, vp, pools, scales, region
    return err, rel


def check_k10_main(dtype, gen, quant):
    """check_k10 at the serve's width; the per-row check's reading goes
    on its own line."""
    err, rel = check_k10(dtype, gen, quant)
    emit({"phase": "kernels", "kernel": "ragged_verify_int8" if quant else "ragged_verify",
          "dtype": str(dtype).split(".")[-1], "row_rel_err": rel,
          "row_rel_bound": K4_SLOT_REL})
    return err


def check_k10_deterministic(gen, quant):
    """Two launches of the bf16 K10 on the same inputs (the serve's width):
    bitwise-equal outputs (real queries) and pools (scratch page 0
    excluded). The second launch writes the same draft bits over the
    first's, so its inputs are the first's."""
    import torch

    from orion_tpu_torch import ops

    cuda = ops.ragged_verify_int8_cuda if quant else ops.ragged_verify_cuda
    shape = k10_main_shape()
    q, kp, vp, table, start, lens, kn, vn, base, scales = k10_inputs(
        torch.bfloat16, gen, quant, **shape)
    kw = dict(layer_base=base, k_new=kn, v_new=vn, **scales)
    first = cuda(q, kp, vp, table, start, lens, **kw)[0]
    pools = [t.clone() for t in (kp, vp, *scales.values())]
    second = cuda(q, kp, vp, table, start, lens, **kw)[0]
    torch.cuda.synchronize()
    real = torch.arange(q.shape[1], device="cuda")[None] < lens[:, None]
    real[torch.tensor(shape["pad"], device="cuda")] = False
    keep = torch.ones(kp.shape[0], dtype=torch.bool, device="cuda")
    keep[base] = False   # scratch page 0: the pad rows' writes, in no order
    if not (torch.equal(bits(first[real]), bits(second[real]))
            and all(torch.equal(bits(a[keep]), bits(b[keep]))
                    for a, b in zip(pools, (kp, vp, *scales.values())))):
        raise AssertionError(f"ragged_verify{'_int8' if quant else ''}: two launches differ")
    del q, kp, vp, pools, scales


def verify_merge_inputs(gen):
    """K10's split partials at the kernels phase's K10 shapes (32 slots,
    W = 5, the table's 128 pages in splits of VERIFY_SPLIT_PAGES): O
    standard normal, m in (-4, 4), l in (0.5, 4.5), and in every slot one
    (query, head) whose first active split attended nothing (m NEG_INF, l
    0, O 0)."""
    import torch

    from orion_tpu_torch.ops.ragged_paged_attention import verify_n_splits

    P = 8192 // PSZ
    n_sp = verify_n_splits(P)
    shape = k10_main_shape()
    o = torch.randn(n_sp, B_DEC, K10_W, N_HEADS, HEAD, generator=gen, device="cuda")
    ml = torch.rand(n_sp, B_DEC, K10_W, N_HEADS, 2, generator=gen, device="cuda")
    ml[..., 0] = 8 * ml[..., 0] - 4
    ml[..., 1] = 4 * ml[..., 1] + 0.5
    ml[0, :, 1, 0, 0], ml[0, :, 1, 0, 1], o[0, :, 1, 0] = -1e30, 0.0, 0.0
    dev = dict(dtype=torch.int32, device="cuda")
    start, lens = torch.tensor(shape["starts"], **dev), torch.tensor(shape["lens"], **dev)
    out = torch.randn(B_DEC, K10_W, N_HEADS, HEAD, generator=gen,
                      device="cuda").to(torch.bfloat16)
    return o, ml, start, lens, out, dict(page_size=PSZ, n_pages=P)


def verify_merged(start, lens, kw):
    """Active splits of each K10 slot (more than one: the merge writes it)."""
    from orion_tpu_torch.ops.ragged_paged_attention import verify_active_splits

    return [len(verify_active_splits(s, n, **kw)) for s, n in zip(start.tolist(), lens.tolist())]


def check_verify_merge(gen):
    """K10's merge kernel against its plain version: the merged slots, and
    every other slot of ``out`` untouched."""
    import torch

    from orion_tpu_torch import ops

    o, ml, start, lens, out, kw = verify_merge_inputs(gen)
    want = ops.ragged_verify_merge_plain(o, ml, start, lens, out.clone(), **kw)
    before = out.clone()
    got = ops.ragged_verify_merge_cuda(o, ml, start, lens, out, **kw)
    torch.cuda.synchronize()
    merged = torch.tensor([n > 1 for n in verify_merged(start, lens, kw)], device="cuda")
    if not torch.equal(bits(got[~merged]), bits(before[~merged])):
        raise AssertionError("ragged_verify_merge: a slot with one split changed")
    return require_close("ragged_verify_merge", "bfloat16", got, want)


def k10_twice(dtype, gen, quant, shape, first, second):
    """Run ``first(args, kw)`` and ``second(args, kw)`` (kernel calls) on
    copies of the same inputs; returns both outputs and both pool sets."""
    q, kp, vp, table, start, lens, kn, vn, base, scales = k10_inputs(dtype, gen, quant, **shape)
    pools_a = [kp, vp, *scales.values()]
    pools_b = [t.clone() for t in pools_a]
    outs = []
    for fn, pools in ((first, pools_a), (second, pools_b)):
        sc = dict(zip(scales, pools[2:]))
        outs.append(fn((q, *pools[:2], table, start, lens),
                       dict(layer_base=base, k_new=kn, v_new=vn, **sc)))
    return outs, pools_a, pools_b, base


def k10_chain_tree_bitwise(dtype, gen, quant, window):
    """A chain-shaped tree gives bitwise the chain's outputs (real queries)
    and writes (scratch page 0 excluded)."""
    import torch

    from orion_tpu_torch import ops

    cuda = ops.ragged_verify_int8_cuda if quant else ops.ragged_verify_cuda
    shape = k10_small_shape(5, 16, 8, N=8, K=2, H=128)
    depths, words = tree_arrays(5, 5, list(range(4)))
    (a, b), pa, pb, base = k10_twice(
        dtype, gen, quant, shape,
        lambda args, kw: cuda(*args, window=window, **kw)[0],
        lambda args, kw: cuda(*args, window=window, tree_mask=words, depths=depths, **kw)[0])
    keep = torch.ones(pa[0].shape[0], dtype=torch.bool, device=a.device)
    keep[base] = False   # scratch page 0
    real = torch.tensor([[not p and w < n for w in range(5)]
                         for p, n in zip(shape["pad"], shape["lens"])], device=a.device)
    if not (torch.equal(bits(a[real]), bits(b[real]))
            and all(torch.equal(bits(x[keep]), bits(y[keep])) for x, y in zip(pa, pb))):
        raise AssertionError(f"ragged_verify chain-shaped tree (window {window}): not bitwise")


def k10_w1_vs_k4(dtype, gen, quant):
    """W = 1 against K4 on the same inputs: outputs within TOL, pool writes
    byte-identical (scratch page 0 excluded)."""
    import torch

    from orion_tpu_torch import ops

    k10 = ops.ragged_verify_int8_cuda if quant else ops.ragged_verify_cuda
    k4 = ops.paged_attention_int8_cuda if quant else ops.paged_attention_cuda
    shape = k10_small_shape(1, 16, 8, N=8, K=2, H=128)
    (a, b), pa, pb, base = k10_twice(
        dtype, gen, quant, shape,
        lambda args, kw: k10(*args, **kw)[0][:, 0],
        lambda args, kw: k4(args[0][:, 0], *args[1:4], args[4], **dict(
            kw, k_new=kw["k_new"][:, 0], v_new=kw["v_new"][:, 0]))[0])
    require_bytes_equal("ragged_verify W=1 vs paged_decode",
                        [t[base + 1:base + 64] for t in pa], [t[base + 1:base + 64] for t in pb])
    name = "paged_decode_int8" if quant else "paged_decode"
    real = ~torch.tensor(shape["pad"], device="cuda")
    return require_close(name, str(dtype).split(".")[-1], a, b, rows=real)


K10_VARIANTS = (
    # (label, W, psz, P, N, K, H, window, softcap, tree, layer, rows)
    ("page16", 5, 16, 8, 8, 2, 128, None, None, None, 1, None),
    ("H64_W8_softcap", 8, 64, 4, 8, 2, 64, None, 30.0, None, 1, None),
    ("H256_window_layer0", 5, 64, 4, 4, 2, 256, 40, None, None, 0, None),
    ("W31", 31, 64, 4, 8, 2, 128, None, None, None, 1, None),
    ("tree", 5, 16, 8, 8, 2, 128, None, None, (0, 1, 0, 3), 1, None),
    ("tree_window", 5, 16, 8, 8, 2, 128, 3, None, (0, 1, 0, 3), 1, None),
    ("tree_W8_window_softcap", 8, 16, 8, 4, 1, 64, 20, 50.0, (0, 1, 0, 3, 3, 5, 2), 1, None),
    # The split walk (8 pages a split: 128 keys at page 16), rows of
    # K10_SPLIT_ROWS.
    ("splits16", 5, 16, 128, 8, 2, 128, None, None, None, 1, "splits16"),
    ("straddle_chain", 5, 16, 32, 8, 2, 128, None, None, None, 1, "straddle"),
    ("straddle_chain_window_softcap", 5, 16, 32, 8, 2, 128, 20, 30.0, None, 1, "straddle"),
    ("straddle_tree", 5, 16, 32, 8, 2, 128, None, None, (0, 1, 0, 3), 1, "straddle"),
    ("straddle_tree_window", 5, 16, 32, 8, 2, 128, 20, None, (0, 1, 0, 3), 1, "straddle"),
    # Row tiles of the bf16 kernel's passes (8 tiles at H 16, 4 at H 32):
    # G 8 over 3 tiles; a tree over 4; W = 64 (16 tiles, four passes of 4
    # at H 128), which only the bf16 fit check admits.
    ("H16_G8_window", 5, 16, 8, 16, 2, 16, 9, None, None, 1, None),
    ("H32_tree_W8_softcap", 8, 32, 8, 8, 1, 32, None, 20.0, (0, 1, 0, 3, 3, 5, 2), 1, None),
    ("W64_bf16_only", 64, 64, 4, 8, 2, 128, None, None, None, 1, None),
)

# Row layouts (starts, lens, pad, pool pages per layer) of the split
# variants, at page 16 (a split is 128 keys). "splits16": one row over all
# 16 splits of a 128-page table (its drafts at the table's end), one whose
# drafts straddle the first split boundary (start 126: two tokens in split
# 0, three in split 1), a short row mid-split and a single query. "straddle":
# drafts straddling the boundaries at 128 (start 126), 256 (start 255: one
# token before it) and 384 (start 381); the row at 272, under the tree
# (0, 1, 0, 3) and a window of 20, has query 4 at depth 2 whose context
# window opens at 272 + 2 - 19 = 255, in split 1, where a chain query 4's
# would open at 257, in split 2.
K10_SPLIT_ROWS = {
    "splits16": ([0, 2043, 126, 391, 100], [1, 5, 5, 3, 1], 192),
    "straddle": ([0, 126, 255, 272, 381], [1, 5, 5, 5, 5], 96),
}


def k10_split_shape(rows, W, psz, P, **heads):
    """A K10_SPLIT_ROWS layout on a two-layer pool (row 0 a pad row)."""
    starts, lens, NP = K10_SPLIT_ROWS[rows]
    return dict(starts=list(starts), lens=list(lens), pad=[True] + [False] * (len(starts) - 1),
                W=W, psz=psz, P=P, NP=NP, L=2, **heads)


def k10_variants(gen):
    """K10 off the serve's shapes (table K10_VARIANTS), in both pool
    branches and both dtypes (a dtype whose fit check refuses the width
    is recorded as refused), each real query row also within K4_SLOT_REL
    of its output RMS; a chain-shaped tree bitwise against the chain; W = 1
    against K4."""
    import torch

    from orion_tpu_torch import ops

    out = []
    for label, W, psz, P, N, K, H, window, cap, tree, layer, rows in K10_VARIANTS:
        if rows is None:
            shape = k10_small_shape(W, psz, P, N=N, K=K, H=H, layer=layer)
        else:
            shape = k10_split_shape(rows, W, psz, P, N=N, K=K, H=H, layer=layer)
        for dtype in (torch.float32, torch.bfloat16):
            try:
                ops.check_verify_fit(W, n_heads=N, n_kv_heads=K, head_dim=H, page_size=psz,
                                     dtype=dtype)
            except ValueError:
                out.append({"variant": label, "W": W, "dtype": str(dtype).split(".")[-1],
                            "refused_by_fit_check": True})
                continue
            errs, rel = {}, {}
            for name, quant in (("ragged_verify", False), ("ragged_verify_int8", True)):
                errs[name], rel[name] = check_k10(dtype, gen, quant, shape, tree=tree,
                                                  window=window, logit_softcap=cap)
            out.append({"variant": label, "W": W, "page_size": psz, "pages": P, "H": H,
                        "N": N, "K": K, "window": window, "softcap": cap, "tree": tree,
                        "layer": layer, "starts": shape["starts"],
                        "dtype": str(dtype).split(".")[-1], **errs, "row_rel_err": rel})
    for dtype in (torch.float32, torch.bfloat16):
        for quant in (False, True):
            for window in (None, 20):
                k10_chain_tree_bitwise(dtype, gen, quant, window)
            out.append({"variant": "W1_vs_paged_decode", "dtype": str(dtype).split(".")[-1],
                        "int8": quant, "max_abs_err": k10_w1_vs_k4(dtype, gen, quant)})
    out.append({"variant": "chain_shaped_tree", "bitwise": True})
    return out


def nan_containment(name, launch, cache, page, victim, rows, wrows, quant):
    """The kernel-level property the NaN quarantine rests on, for one
    kernel and pool branch: ``launch()`` runs the kernel on ``cache``'s
    pools (writing them in place; a second launch writes the same bytes).
    A clean launch with page ``page`` scrubbed (zeros) is the reference.
    Then ``poison_page`` (NaN K rows; int8: NaN k_scale rows) of that page,
    which only slot ``victim`` reads: every output row of the victim
    (``rows`` [B, ...] bool: the rows compared) must be non-finite, every
    other slot's rows and the pool rows ``wrows`` other slots write
    bitwise equal to the reference. Then ``scrub_pages`` of the page: every
    compared row and ``wrows`` bitwise equal to the reference again."""
    import torch

    from orion_tpu_torch.infer.kv_cache import poison_page, scrub_pages

    kw = dict(n_layers=N_LAYERS, num_pages=NUM_PAGES)
    pools = list(cache.values())
    scrub_pages(cache, [page], **kw)
    ref = launch().clone()
    ref_rows = [t[wrows].clone() for t in pools]
    others = rows.clone()
    others[victim] = False
    poison_page(cache, page, **kw)
    out = launch()
    torch.cuda.synchronize()
    res = {
        "victim_nonfinite": not bool(torch.isfinite(out[victim][rows[victim]].float()).any()),
        "others_bitwise": torch.equal(bits(out[others]), bits(ref[others])),
        "pool_writes_bitwise": all(torch.equal(bits(t[wrows]), bits(r))
                                   for t, r in zip(pools, ref_rows)),
    }
    scrub_pages(cache, [page], **kw)
    out = launch()
    torch.cuda.synchronize()
    res["scrubbed_bitwise"] = (torch.equal(bits(out[rows]), bits(ref[rows]))
                               and all(torch.equal(bits(t[wrows]), bits(r))
                                       for t, r in zip(pools, ref_rows)))
    emit({"phase": "kernels", "nan_containment": name, "pool": "int8" if quant else "bf16",
          "dtype": "bfloat16", "victim": victim, "poisoned_page": page, **res})
    bad = [k for k, ok in res.items() if not ok]
    if bad:
        raise AssertionError(f"{name} NaN containment ({'int8' if quant else 'bf16'} pool): "
                             f"failed {bad}")


def check_nan_containment(gen):
    """NaN-containment rows of K4, K10 and K9 in both pool branches at the
    kernels phase's shapes: the victim is a slot whose walk spans several
    splits, poisoned in its first split (not the last one)."""
    import torch

    from orion_tpu_torch import ops

    for quant in (False, True):
        q, kp, vp, table, lp, kn, vn, base, scales = k4_inputs(torch.bfloat16, gen, quant)
        cuda = ops.paged_attention_int8_cuda if quant else ops.paged_attention_cuda
        v = B_DEC - 1                     # last_pos 8191: 16 splits
        live = torch.arange(B_DEC, device="cuda") >= 2
        wr = base + table[torch.arange(B_DEC, device="cuda"), lp // PSZ].long()
        wrows = wr[live & (torch.arange(B_DEC, device="cuda") != v)]
        cache = {"k": kp, "v": vp, **scales}
        nan_containment(
            "paged_decode", lambda: cuda(q, kp, vp, table, lp, layer_base=base, k_new=kn,
                                         v_new=vn, **scales)[0],
            cache, int(table[v, 0]), v, live[:, None, None].expand(-1, *q.shape[1:]).clone(),
            wrows, quant)
        del q, kp, vp, cache, scales
        torch.cuda.empty_cache()

        shape = k10_main_shape()
        q, kp, vp, table, start, lens, kn, vn, base, scales = k10_inputs(
            torch.bfloat16, gen, quant, **shape)
        cuda = ops.ragged_verify_int8_cuda if quant else ops.ragged_verify_cuda
        B, W = q.shape[:2]
        v = B - 2                          # start ~7687: the walk spans 16 splits
        real = torch.arange(W, device="cuda")[None] < lens[:, None]
        real[torch.tensor(shape["pad"], device="cuda")] = False
        wrows = torch.unique(base + table[[b for b in range(B) if b != v]].long())
        wrows = wrows[wrows != base]
        cache = {"k": kp, "v": vp, **scales}
        nan_containment(
            "ragged_verify", lambda: cuda(q, kp, vp, table, start, lens, layer_base=base,
                                          k_new=kn, v_new=vn, **scales)[0],
            cache, int(table[v, 0]), v, real[:, :, None, None].expand(-1, -1, *q.shape[2:]).clone(),
            wrows, quant)
        del q, kp, vp, cache, scales
        torch.cuda.empty_cache()

        q, kp, vp, walk, start, lens, kn, vn, base, scales, P_pre = k9_inputs(
            torch.bfloat16, gen, quant)
        cuda = ops.paged_flash_prefill_int8_cuda if quant else ops.paged_flash_prefill_cuda
        B, S = q.shape[:2]
        v = 2                              # start 4096: 64 history pages, 4 splits
        real = torch.arange(S, device="cuda")[None] < lens[:, None]
        wrows = (base + walk[[b for b in range(B) if b != v], P_pre:].long()).reshape(-1)
        wrows = wrows[wrows != base]
        cache = {"k": kp, "v": vp, **scales}
        nan_containment(
            "paged_prefill", lambda: cuda(q, kp, vp, walk, start, lens, kn, vn,
                                          n_prefix_pages=P_pre, layer_base=base,
                                          **scales)[0],
            cache, int(walk[v, 0]), v, real[:, :, None, None].expand(-1, -1, *q.shape[2:]).clone(),
            wrows, quant)
        del q, kp, vp, cache, scales
        torch.cuda.empty_cache()


# K3's explicit-positions branch at the gather prefill body's shapes: 4
# rows whose 256-token tails (K9_LENS real) resume over prefixes of
# K9_STARTS tokens, the prefix gathered at [0, 128 pages x 64) as the
# runner gathers it, llama3-8b-infer heads; with no window and Mistral's.
# And a striped permutation (positions j*STRIPES + r: what sequence
# parallelism gives a shard) at the training path's shapes, causal.
K3POS_P_PRE, K3POS_WINDOW, STRIPES = 128, 4096, 4


def k3pos_gather_inputs(dtype, gen):
    import torch

    B, S, n_pre = len(K9_STARTS), K9_S, K3POS_P_PRE * PSZ
    q = torch.randn(B, S, N_HEADS, HEAD, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, n_pre + S, N_KV, HEAD, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, n_pre + S, N_KV, HEAD, generator=gen, device="cuda").to(dtype)
    start = torch.tensor(K9_STARTS, device="cuda")[:, None]
    lens = torch.tensor(K9_LENS, device="cuda")[:, None]
    ar, pre = torch.arange(S, device="cuda"), torch.arange(n_pre, device="cuda")
    qpos = (start + ar).to(torch.int32)
    qseg = (ar[None] < lens).to(torch.int32)
    kw = dict(q_positions=qpos,
              kv_positions=torch.cat([pre.expand(B, -1).to(torch.int32), qpos], 1),
              q_segment_ids=qseg,
              kv_segment_ids=torch.cat([(pre[None] < start).to(torch.int32), qseg], 1))
    return q, k, v, kw


def k3pos_striped_inputs(dtype, gen):
    import torch

    q, k, v, _ = t_attn_inputs(dtype, gen)
    S = q.shape[1]
    perm = torch.arange(S, device="cuda").reshape(S // STRIPES, STRIPES).t().reshape(-1)
    pos = perm[None].expand(q.shape[0], -1).to(torch.int32).contiguous()
    return q, k, v, dict(q_positions=pos, kv_positions=pos)


def check_k3pos(dtype, gen):
    """K3's explicit-positions branch against attention_plain (and its lse
    against attention_lse_plain) with the same positions: the gather body's
    layout without and with a window (real rows compared), and the striped
    permutation, causal. bf16 (the split walk): two launches give the same
    bits, the split run is within TOL of the one-split run, and the many-
    splits shape holds. Then identity positions at the serve's prefill
    shapes must give K3's index path bit for bit, on one split (the same
    steps in the same order; a step one path skips and the other computes
    is wholly masked). Returns the max error."""
    import torch

    from orion_tpu_torch import ops

    dn = str(dtype).split(".")[-1]
    bf16 = dtype == torch.bfloat16
    errs = []
    q, k, v, kw = k3pos_gather_inputs(dtype, gen)
    real = kw["q_segment_ids"] > 0
    args = (q, k, v, kw["q_positions"], kw["kv_positions"])
    seg = dict(q_segment_ids=kw["q_segment_ids"], kv_segment_ids=kw["kv_segment_ids"],
               seg_pad_zero=True)
    for window in (None, K3POS_WINDOW):
        got, lse = ops.flash_attention_pos_cuda(*args, window=window, return_lse=True, **seg)
        errs.append(require_close("flash_fwd_pos", dn, got,
                                  ops.attention_plain(q, k, v, window=window, **kw), rows=real))
        require_close("flash_lse", dn, lse.transpose(1, 2),
                      ops.attention_lse_plain(q, k, window=window, **kw).transpose(1, 2),
                      rows=real)
        if bf16:
            again, lse2 = ops.flash_attention_pos_cuda(*args, window=window, return_lse=True,
                                                       **seg)
            if not (torch.equal(bits(got), bits(again)) and torch.equal(bits(lse), bits(lse2))):
                raise AssertionError(f"K3-pos bf16 window={window}: two launches differ")
            one = ops.flash_attention_pos_cuda(*args, window=window, _one_split=True, **seg)
            errs.append(require_close("flash_fwd_pos", dn, got, one, rows=real))
    del q, k, v, got, lse, args
    q, k, v, kw = k3pos_striped_inputs(dtype, gen)
    got, lse = ops.flash_attention_pos_cuda(q, k, v, kw["q_positions"], kw["kv_positions"],
                                            return_lse=True)
    errs.append(require_close("flash_fwd_pos", dn, got, ops.attention_plain(q, k, v, **kw)))
    require_close("flash_lse", dn, lse, ops.attention_lse_plain(q, k, **kw))
    del q, k, v, got, lse
    if bf16:
        errs.append(check_k3pos_many_splits(gen))
    q, k, v, seg = k3_inputs(dtype, gen)
    pos = torch.arange(S_PRE, device="cuda", dtype=torch.int32).expand(B_PRE, -1).contiguous()
    kw = dict(q_segment_ids=seg, kv_segment_ids=seg, seg_pad_zero=True)
    if not torch.equal(bits(ops.flash_attention_pos_cuda(q, k, v, pos, pos, _one_split=True,
                                                         **kw)),
                       bits(ops.flash_attention_cuda(q, k, v, **kw))):
        raise AssertionError(f"K3 {dn}: identity positions differ from the index path")
    torch.cuda.empty_cache()
    return max(errs)


# The many-splits shape: a 16384-key prefix (520 key steps: 5 splits in
# the grid at these widths); row 0 resumes at 0 (its blocks walk the tail
# alone: one active split, four with no live step), row 1 over the whole
# prefix (every split active), and row 2 attends nothing (its kv positions
# all past its queries'). With a window on row 1's long walk too.
K3POS_MANY_PRE = 16384


def check_k3pos_many_splits(gen):
    """The bf16 split walk where most splits of a block have no live step
    and one row attends nothing: real rows against attention_plain and
    attention_lse_plain, row 2 exactly zeros with lse NEG_INF, with and
    without a window. Returns the max error."""
    import torch

    from orion_tpu_torch import ops
    from orion_tpu_torch.ops.flash_pos import grid_splits

    B, S, n_pre = 3, K9_S, K3POS_MANY_PRE
    q = torch.randn(B, S, N_HEADS, HEAD, generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn(B, n_pre + S, N_KV, HEAD, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(B, n_pre + S, N_KV, HEAD, generator=gen, device="cuda").to(torch.bfloat16)
    ar, pre = torch.arange(S, device="cuda"), torch.arange(n_pre, device="cuda")
    qpos = torch.stack([ar, n_pre + ar, ar]).to(torch.int32)
    kpos = torch.cat([pre.expand(B, -1), qpos], 1).to(torch.int32)
    kpos[2] += 10 ** 6
    kseg = torch.ones(B, n_pre + S, dtype=torch.int32, device="cuda")
    kseg[0, :n_pre] = 0
    qseg = torch.ones(B, S, dtype=torch.int32, device="cuda")
    kw = dict(q_positions=qpos, kv_positions=kpos, q_segment_ids=qseg, kv_segment_ids=kseg)
    if grid_splits(B, S, n_pre + S, N_HEADS, N_KV) < 4:
        raise AssertionError("K3-pos many splits: the grid does not split")
    errs = []
    for window in (None, K3POS_WINDOW):
        got, lse = ops.flash_attention_pos_cuda(q, k, v, qpos, kpos, q_segment_ids=qseg,
                                                kv_segment_ids=kseg, seg_pad_zero=True,
                                                window=window, return_lse=True)
        if got[2].any() or not (lse[2] <= -1e30 / 2).all() or (lse[:2] <= -1e30 / 2).any():
            raise AssertionError(f"K3-pos many splits window={window}: the row that "
                                 "attends nothing is not zeros with lse NEG_INF")
        errs.append(require_close("flash_fwd_pos", "bfloat16", got,
                                  ops.attention_plain(q, k, v, window=window, **kw)))
        require_close("flash_lse", "bfloat16", lse,
                      ops.attention_lse_plain(q, k, window=window, **kw))
    del q, k, v, got, lse
    torch.cuda.empty_cache()
    return max(errs)


# K7-pos/K8-pos's dead-block row: a windowed ring's past block (queries at
# s_loc + i, keys at j) under a window of 100, so query rows from 99 on, a
# whole 128-row block and more, attend nothing.
POSB_S, POSB_WINDOW = 512, 100


def pos_grads_plain(q, k, v, do, g_lse, kw):
    """dq, dk, dv of attention_plain's output and attention_lse_plain's lse
    (NEG_INF, a constant, on rows that attend nothing) for the cotangents
    ``do`` and ``g_lse``."""
    import torch

    from orion_tpu_torch import ops

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = ops.attention_plain(*leaves, **kw)
    lse = ops.attention_lse_plain(leaves[0], leaves[1], **kw)
    return torch.autograd.grad([out, lse], leaves, [do, g_lse])


def pos_grads_kernel(q, k, v, do, g_lse, kw):
    """K3-pos (with lse), then K7-pos and K8-pos with the lse cotangent."""
    from orion_tpu_torch import ops

    kkw = {key: val for key, val in kw.items() if key not in ("q_positions", "kv_positions")}
    qpos, kpos = kw["q_positions"], kw["kv_positions"]
    out, lse = ops.flash_attention_pos_cuda(q, k, v, qpos, kpos, return_lse=True, **kkw)
    return ops.flash_attention_bwd_cuda(q, k, v, out, lse, do, g_lse=g_lse, q_positions=qpos,
                                        kv_positions=kpos, **kkw)


def check_flash_pos_train(dtype, gen):
    """K7-pos and K8-pos against autograd of the plain attention and its
    lse, with the same positions and a nonzero lse cotangent: the striped
    permutation at the training shapes (check_k3pos's), causal, without and
    with a window; the windowed ring's past block whose query rows from
    POSB_WINDOW - 1 on attend nothing (their dq and the keys no row reaches
    exactly zero, every gradient finite); two launches give the same bits.
    Returns max errors by kernel."""
    import torch

    dn = str(dtype).split(".")[-1]
    errs = {"flash_dq_pos": 0.0, "flash_dkv_pos": 0.0}

    def check(q, k, v, do, g_lse, kw):
        got = pos_grads_kernel(q, k, v, do, g_lse, kw)
        for name, t in zip(("dq", "dk", "dv"), got):
            if not torch.isfinite(t).all():
                raise AssertionError(f"K7/K8-pos {dn}: non-finite {name}")
        want = pos_grads_plain(q, k, v, do, g_lse, kw)
        errs["flash_dq_pos"] = max(errs["flash_dq_pos"],
                                   require_close("flash_dq_pos", dn, got[0], want[0]))
        errs["flash_dkv_pos"] = max(errs["flash_dkv_pos"], *(
            require_close("flash_dkv_pos", dn, a, b) for a, b in zip(got[1:], want[1:])))
        return got

    q, k, v, pkw = k3pos_striped_inputs(dtype, gen)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    g_lse = torch.randn(q.shape[0], q.shape[2], q.shape[1], generator=gen, device="cuda")
    for window in (None, 256):
        got = check(q, k, v, do, g_lse, dict(pkw, causal=True, window=window))
        again = pos_grads_kernel(q, k, v, do, g_lse, dict(pkw, causal=True, window=window))
        if not all(torch.equal(bits(a), bits(b)) for a, b in zip(got, again)):
            raise AssertionError(f"K7/K8-pos {dn} window={window}: two launches differ")
    del q, k, v, do, g_lse, got, again
    torch.cuda.empty_cache()

    q, k, v, do = t_attn_inputs(dtype, gen, B=2, S=POSB_S)
    g_lse = torch.randn(2, T_N, POSB_S, generator=gen, device="cuda")
    iota = torch.arange(POSB_S, device="cuda", dtype=torch.int32)
    kw = dict(q_positions=(POSB_S + iota).expand(2, -1).contiguous(),
              kv_positions=iota.expand(2, -1).contiguous(), causal=True, window=POSB_WINDOW)
    dq, dk, dv = check(q, k, v, do, g_lse, kw)
    dead = POSB_WINDOW - 1   # query rows from here on attend nothing
    if dq[:, dead:].any() or dk[:, :POSB_S - POSB_WINDOW + 1].any() \
            or dv[:, :POSB_S - POSB_WINDOW + 1].any():
        raise AssertionError(f"K7/K8-pos {dn}: gradients of a masked block are not zero")
    del q, k, v, do, g_lse, dq, dk, dv
    torch.cuda.empty_cache()
    return errs


def pos_merge_inputs(gen, *, B=4, S=K9_S, N=N_HEADS, K=N_KV, H=HEAD, n_sp=8):
    """Partials of the positions kernel's merge at the gather body's widths:
    float32 O and (m, l) of n_sp splits, each (row, q tile) block with 1 to
    n_sp active splits (cycling), and one query row of each merged block
    whose splits attended nothing (m NEG_INF, l 0, O 0); out and lse
    filled with noise the merge must overwrite only on merged blocks."""
    import torch

    from orion_tpu_torch.ops.common import q_tile

    tq = q_tile(N // K)
    n_qt = -(-S // tq)
    o = torch.randn(n_sp, B, S, N, H, generator=gen, device="cuda")
    ml = torch.randn(n_sp, B, S, N, 2, generator=gen, device="cuda")
    ml[..., 0] *= 4
    ml[..., 1] = 4 * ml[..., 1].abs() + 0.5
    n_act = (torch.arange(B * n_qt, device="cuda") % n_sp + 1).to(torch.int32).view(B, n_qt)
    ml[:, :, ::tq, :, 0], ml[:, :, ::tq, :, 1], o[:, :, ::tq] = -1e30, 0.0, 0.0
    out = torch.randn(B, S, N, H, generator=gen, device="cuda").to(torch.bfloat16)
    lse = torch.randn(B, N, S, generator=gen, device="cuda")
    return o, ml, n_act, out, lse, tq


def check_pos_merge(gen):
    """K3-pos's merge kernel against its plain version: the merged rows
    (out and lse; a row with nothing attended 0 and NEG_INF) and every
    other row of out and lse untouched."""
    import torch

    from orion_tpu_torch import ops

    o, ml, n_act, out, lse, tq = pos_merge_inputs(gen)
    want, want_lse = ops.flash_pos_merge_plain(o, ml, n_act, out.clone(), lse.clone(), tq=tq)
    before, before_lse = out.clone(), lse.clone()
    got, got_lse = ops.flash_pos_merge_cuda(o, ml, n_act, out, lse, tq=tq)
    torch.cuda.synchronize()
    merged = (n_act > 1).repeat_interleave(tq, dim=1)[:, :out.shape[1]]   # [B, S]
    if not (torch.equal(bits(got[~merged]), bits(before[~merged]))
            and torch.equal(bits(got_lse.transpose(1, 2)[~merged]),
                            bits(before_lse.transpose(1, 2)[~merged]))):
        raise AssertionError("flash_fwd_pos_merge: a row of a one-split block changed")
    empty = torch.zeros_like(merged)
    empty[:, ::tq] = True
    empty &= merged
    if got[empty].any() or not (got_lse.transpose(1, 2)[empty] <= -1e30 / 2).all():
        raise AssertionError("flash_fwd_pos_merge: a row with nothing attended is not 0")
    require_close("flash_lse", "bfloat16", got_lse, want_lse)
    return require_close("flash_fwd_pos_merge", "bfloat16", got, want)


def k3pos_pairs(qpos, kpos, qseg, kseg, window):
    """(query, key) pairs in the (16-row warp, 32-key step) tiles that the
    first K3 positions kernel computed on this data: tiles not skipped by
    their position extremes or by seg_pad_zero liveness (64-row q tiles).
    Printed beside the admitted pairs, which the bound now reads."""
    import torch

    B, Sq = qpos.shape
    Skv = kpos.shape[1]
    qp = qpos.view(B, Sq // 16, 16).long()
    kp = kpos.view(B, Skv // 32, 32).long()
    pmin, pmax = qp.amin(-1)[:, :, None], qp.amax(-1)[:, :, None]
    kmin, kmax = kp.amin(-1)[:, None, :], kp.amax(-1)[:, None, :]
    dead = kmin > pmax
    if window is not None:
        dead |= kmax <= pmin - window
    live = ~dead
    if qseg is not None:
        qlive = (qseg.view(B, Sq // 64, 64) > 0).any(-1).repeat_interleave(4, dim=1)
        klive = (kseg.view(B, Skv // 32, 32) > 0).any(-1)
        live &= qlive[:, :, None] & klive[:, None, :]
    return int(live.sum()) * 16 * 32


def k3pos_admitted_pairs(q, k, kw, window):
    """(query, key) pairs the mask admits over the real query rows (segment
    > 0): the work of attention with these positions, whatever the tiling."""
    from orion_tpu_torch import ops

    mask = ops.attention_mask(q.shape[1], k.shape[1], causal=True, window=window, **kw)
    return int((mask & (kw["q_segment_ids"] > 0)[:, :, None]).sum())


def phase_kernels():
    import torch

    from orion_tpu_torch import ops

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        x, s = k1_inputs(dtype, gen)
        e1 = require_close("rmsnorm_fwd", dn, ops.rmsnorm_cuda(x, s, 1e-5),
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
        errs[dn] = {"rmsnorm_fwd": e1, "rope_fwd": e2, "flash_fwd": e3,
                    "flash_fwd_pos": check_k3pos(dtype, gen)}
        for name, check, quant in (
            ("paged_decode", check_k4, False), ("paged_decode_int8", check_k4, True),
            ("paged_prefill", check_k9, False), ("paged_prefill_int8", check_k9, True),
            ("ragged_verify", check_k10_main, False),
            ("ragged_verify_int8", check_k10_main, True),
        ):
            errs[dn][name] = check(dtype, gen, quant)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        if dtype == torch.bfloat16:
            errs[dn]["paged_prefill_merge"] = check_merge(gen)
            errs[dn]["paged_decode_merge"] = check_decode_merge(gen)
            errs[dn]["ragged_verify_merge"] = check_verify_merge(gen)
            errs[dn]["flash_fwd_pos_merge"] = check_pos_merge(gen)
            for quant in (False, True):
                check_k4_deterministic(gen, quant)
                check_k10_deterministic(gen, quant)
            check_nan_containment(gen)
        for name, e in check_train_kernels(dtype, gen).items():
            errs[dn][name] = max(errs[dn].get(name, 0.0), e)
        errs[dn].update(check_flash_pos_train(dtype, gen))
        emit({"phase": "kernels", "dtype": dn, "max_abs_err": errs[dn],
              "tolerance": {k: TOL[k][dn] for k in TOL if dn in TOL[k]}})
    variants = kernel_variants(gen)
    emit({"phase": "kernels", "variants": variants})
    emit({"phase": "kernels", "paged_decode_variants": k4_variants(gen),
          "deterministic": True})
    emit({"phase": "kernels", "paged_prefill_variants": k9_variants(gen)})
    emit({"phase": "kernels", "ragged_verify_variants": k10_variants(gen)})
    emit({"phase": "kernels", "train_variants": train_variants(gen)})
    emit({"phase": "kernels", "norm_variants": norm_variants(gen), "deterministic": True})
    return errs


# K1/K5 off the main shapes: the presets' widths (d_model 2048, 3584, 4096,
# 8192: the kernels' compiled table) and 64, 100 (no multiple of 8) and 768
# (the generic kernels), at row counts from one to a few thousand.
NORM_D = (64, 100, 768, 2048, 3584, 4096, 8192)
NORM_R = (1, 3, 31, 133, 4096)
NORM_DTYPES = (("float32", "float32"), ("bfloat16", "bfloat16"), ("bfloat16", "float32"))


def norm_variants(gen):
    """K1 and K5 against rmsnorm_plain / rmsnorm_bwd_plain at every D of
    NORM_D and R of NORM_R, rows and scale in NORM_DTYPES, and at D 2048
    and 4096 on rows off 16-byte alignment (a view one element into its
    storage: the generic kernels' scalar path): the forward and dx within
    TOL, dscale within TOL["rmsnorm_dscale"]; two K5 launches give the same
    bits (dx and the partial rows), and a launch without dscale the same
    dx. One row per (D, dtypes, alignment), errors the largest over R."""
    import torch

    from orion_tpu_torch import ops

    def rows(R, D, dt, skew):
        flat = torch.randn(R * D + skew, generator=gen, device="cuda").to(dt)
        return flat[skew:].view(R, D)

    out = []
    cases = [(D, dts, 0) for D in NORM_D for dts in NORM_DTYPES]
    cases += [(D, dts, 1) for D in (2048, 4096) for dts in NORM_DTYPES[1:]]
    for D, (xdn, sdn), skew in cases:
        xdt, sdt = getattr(torch, xdn), getattr(torch, sdn)
        e1 = edx = eds = 0.0
        for R in NORM_R:
            x, g = rows(R, D, xdt, skew), rows(R, D, xdt, skew)
            s = (1.0 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(sdt)
            e1 = max(e1, require_close("rmsnorm_fwd", xdn, ops.rmsnorm_cuda(x, s, 1e-5),
                                       ops.rmsnorm_plain(x, s, 1e-5)))
            dx, part = ops.rmsnorm_bwd_partials(x, s, g, 1e-5, True)
            dx2, part2 = ops.rmsnorm_bwd_partials(x, s, g, 1e-5, True)
            dx3, none = ops.rmsnorm_bwd_partials(x, s, g, 1e-5, False)
            what = f"rmsnorm_bwd D={D} R={R} {xdn}/{sdn} skew={skew}"
            if not (torch.equal(bits(dx), bits(dx2)) and torch.equal(bits(part), bits(part2))):
                raise AssertionError(f"{what}: two launches differ")
            if none is not None or not torch.equal(bits(dx), bits(dx3)):
                raise AssertionError(f"{what}: the launch without dscale differs")
            pdx = ops.rmsnorm_bwd_plain(x, s, g, 1e-5)[0]
            edx = max(edx, require_close("rmsnorm_bwd", xdn, dx, pdx))
            eds = max(eds, check_dscale(x, s, g, part, part.sum(dim=0).to(sdt)))
        out.append({"D": D, "dtype": xdn, "scale_dtype": sdn, "unaligned": bool(skew),
                    "rows": list(NORM_R), "rmsnorm_fwd": e1, "rmsnorm_bwd": edx,
                    "rmsnorm_dscale_of_rms": eds})
        torch.cuda.empty_cache()
    return out


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
            # K4's int8 branch on the same table: pools and scales byte-equal.
            kq, vq, sc = rand_pools(dtype, gen, 40, K, psz, H, True)
            plain_pools = [t.clone() for t in (kq, vq, *sc.values())]
            res_k = ops.paged_attention_int8_cuda(qd, kq, vq, table, lp, **sc, **kw4)
            res_p = ops.paged_attention_plain(
                qd, *plain_pools[:2], table, lp, k_scale=plain_pools[2],
                v_scale=plain_pools[3], **kw4)
            require_bytes_equal(f"paged_decode_int8 variant H={H} {dn}", res_k[1:], res_p[1:])
            e4i = require_close("paged_decode_int8", dn, res_k[0], res_p[0])
            out.append({"H": H, "N": N, "K": K, "window": window, "softcap": cap,
                        "q_offset": off, "dtype": dn, "flash_fwd": e3, "paged_decode": e4,
                        "paged_decode_int8": e4i})
    return out


# K4's split walk off the serve's shapes: (label, H, N, K, page size,
# window, softcap, splits in the table); every case has an idle slot, a
# slot whose context is exactly one split, one a key past it, one in the
# middle of a page of the third split and the longest context of the
# table (all 16 splits of a 128-page table in the last row). Windows put
# the lower edge inside a split and leave the longest slot's leading
# splits empty.
K4_VARIANTS = (
    ("G1_page16_window", 128, 8, 8, 16, "split+37", None, 4),
    ("G2_page128_softcap", 128, 4, 2, 128, None, 30.0, 4),
    ("G4_H16", 16, 8, 2, 16, None, None, 4),
    ("G8_H256_window", 256, 8, 1, 64, 100, None, 4),
    ("G4_serve_heads_window_softcap", 128, 32, 8, 64, 1000, 50.0, 4),
    ("G32_H64_two_row_tiles", 64, 64, 2, 16, None, None, 4),
    ("G128_H16_eight_row_tiles", 16, 128, 1, 32, 70, None, 4),
    ("G4_serve_heads_sixteen_splits", 128, 32, 8, 16, None, None, 16),
)


def k4_variants(gen):
    """K4 (both pool branches, both dtypes) off the serve's shapes (table
    K4_VARIANTS) on a two-layer pool, layer 1, of at least 96 pages: pools
    (and scale pools) byte-equal to the plain version's, outputs of the
    live slots within TOL and each slot within K4_SLOT_REL of its RMS."""
    import torch

    from orion_tpu_torch import ops
    from orion_tpu_torch.ops.paged_attention import DECODE_SPLIT_PAGES

    out = []
    for label, H, N, K, psz, window, cap, n_sp in K4_VARIANTS:
        P, sk = n_sp * DECODE_SPLIT_PAGES, DECODE_SPLIT_PAGES * psz
        if window == "split+37":
            window = sk + 37
        last_pos = [0, sk - 1, sk, 2 * sk + psz // 2 + 3, P * psz - 1]
        B = len(last_pos)
        NP = max(96, sum(lp // psz + 1 for lp in last_pos if lp) + 1)
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            errs, rel = {}, {}
            for name, quant in (("paged_decode", False), ("paged_decode_int8", True)):
                kp, vp, sc = rand_pools(dtype, gen, 2 * NP, K, psz, H, quant)
                ids = (torch.randperm(NP - 1, generator=gen, device="cuda") + 1).to(torch.int32)
                table = torch.zeros(B, P, dtype=torch.int32, device="cuda")
                used = 0
                for b, lp in enumerate(last_pos):
                    n = lp // psz + 1 if lp else 0
                    table[b, :n] = ids[used:used + n]
                    used += n
                lp = torch.tensor(last_pos, dtype=torch.int32, device="cuda")
                qd = torch.randn(B, N, H, generator=gen, device="cuda").to(dtype)
                kn = torch.randn(B, K, H, generator=gen, device="cuda").to(dtype)
                vn = torch.randn(B, K, H, generator=gen, device="cuda").to(dtype)
                kw = dict(layer_base=NP, k_new=kn, v_new=vn, logit_softcap=cap, window=window)
                pools = [kp, vp, *sc.values()]
                plain_pools = [t.clone() for t in pools]
                cuda = ops.paged_attention_int8_cuda if quant else ops.paged_attention_cuda
                res_k = cuda(qd, kp, vp, table, lp, **sc, **kw)
                res_p = ops.paged_attention_plain(
                    qd, *plain_pools[:2], table, lp,
                    **dict(zip(sc, plain_pools[2:])), **kw)
                require_bytes_equal(f"{name} variant {label} {dn}", res_k[1:], res_p[1:])
                errs[name] = require_close(name, dn, res_k[0], res_p[0], rows=lp > 0)
                rel[name] = require_slots_close(name, dn, res_k[0], res_p[0], lp > 0)
                del kp, vp, sc, pools, plain_pools
            out.append({"variant": label, "H": H, "N": N, "K": K, "page_size": psz,
                        "pages": P, "split_pages": DECODE_SPLIT_PAGES, "last_pos": last_pos,
                        "window": window, "softcap": cap, "dtype": dn, **errs,
                        "slot_rel_err": rel})
    return out


def k9_variants(gen):
    """K9 (both branches) off the serve's shapes, on small pools: page
    sizes 16-128, head_dim 16-256, G = N / K of 1, 2, 4 and 8, windows,
    softcaps, f32 and bf16 (page 128 at head_dim 128: bf16 only, the f32
    kernel refuses it); every case has a full row, a ragged row, a first
    chunk (start 0) and a pad row. Rows resuming past 32 pages span three
    history splits of the bf16 kernel (SPLIT_PAGES 16), one with a window
    whose lower edge falls inside a split."""
    import torch

    out = []
    for H, N, K, psz, window, cap, n_pre in (
        (64, 8, 2, 16, None, None, 4), (128, 4, 4, 16, 40, 30.0, 4),
        (256, 4, 2, 64, None, 50.0, 4), (128, 8, 2, 64, 100, None, 4),
        (128, 8, 2, 16, 300, None, 40), (64, 4, 4, 32, None, None, 36),
        (128, 4, 2, 32, 500, 30.0, 36), (128, 16, 2, 64, None, None, 4),
        (128, 8, 2, 128, 200, None, 4), (16, 4, 2, 16, None, None, 4),
        (32, 8, 2, 32, 60, 30.0, 36),
    ):
        S = 2 * psz
        shape = dict(N=N, K=K, H=H, psz=psz, S=S, starts=(n_pre * psz, psz, 0, 0),
                     lens=(S, 7, S - 3, 1), NP=64, L=2, window=window, logit_softcap=cap)
        # check_prefill_fit refuses page 128 at head_dim 128 for float32.
        dtypes = (torch.bfloat16,) if psz == 128 and H >= 128 else (torch.float32, torch.bfloat16)
        for dtype in dtypes:
            errs = {name: check_k9(dtype, gen, quant, **dict(shape))
                    for name, quant in (("paged_prefill", False), ("paged_prefill_int8", True))}
            out.append({"H": H, "N": N, "K": K, "page_size": psz, "window": window,
                        "softcap": cap, "history_pages": n_pre,
                        "dtype": str(dtype).split(".")[-1], **errs})
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
    eager = parity_eager(cfg, params, prompts, gpu)
    emit({"phase": "parity", "preset": "tiny-llama", "requests": len(prompts),
          "equal": True, "cuda_streams": gpu, "graphs_vs_eager": eager})
    out = {pools: parity_chunked(params, pools) for pools in ("float32", "int8")}
    out.update({f"spec_{run}": parity_spec(params, run) for run in SPEC_PARITY})
    out["faults"] = parity_faults(params)
    out["constrained"] = parity_constrained(params)
    return out


def sampled_streams(cfg, params, prompts, graphs):
    """Sampled tiny-llama streams on the card (seed 3, temperature 1.0 by
    default; every other request overrides temperature, top-k and top-p,
    so windows run the per-slot variant while those live and the scalar
    one after): captured (``graphs``) or eager."""
    from orion_tpu_torch.infer import InferenceEngine

    eng = InferenceEngine(cfg, params, device="cuda", seed=3, cuda_graphs=graphs)
    reqs = [eng.submit_request(p, 6, **({} if i % 2 else dict(temperature=0.9, top_k=20,
                                                             top_p=0.9)))
            for i, p in enumerate(prompts)]
    while eng.has_work():
        eng.step()
    require_no_faults(eng, "parity sampled")
    return [r.generated for r in reqs], eng._executor


def parity_eager(cfg, params, prompts, captured):
    """serve_graphs (d): the parity prompts on the card with every dispatch
    eager (``cuda_graphs=False``): the greedy streams must equal the
    captured run's, and so must the sampled ones, drawn from one seed."""
    from orion_tpu_torch.config import get_config
    from orion_tpu_torch.infer import InferenceEngine

    eng = InferenceEngine(cfg, params, device="cuda", cuda_graphs=False)
    eager = eng.generate(prompts, 6)
    if eager != captured:
        raise AssertionError(f"parity: eager cuda {eager} != captured {captured}")
    s_cfg = get_config("tiny-llama", INFER_OVERRIDES + ["inference.temperature=1.0"])
    s_graph, ex = sampled_streams(s_cfg, params, prompts, True)
    s_eager, _ = sampled_streams(s_cfg, params, prompts, False)
    if s_graph != s_eager:
        raise AssertionError(f"parity: sampled captured {s_graph} != eager {s_eager}")
    return {"greedy_equal": True, "sampled_equal": True, "sampled_streams": s_graph,
            "captures": ex.captures, "replays": ex.replays}


# The parity phase's fault schedule (tiny-llama, decode window 1, the NaN
# guard, a queue of 3): five requests with mixed priorities (two shed on
# arrival), three more after step 0, a NaN at step 2, a decode dispatch
# fault at step 3, a cancel of a waiting and an active request after step
# 3, an active request's deadline set to now after step 4, a pool fault at
# a page growth (step PARITY_POOL_STEP), then drain() with two
# never-started requests queued.
PARITY_FAULT_OVERRIDES = ["inference.decode_window=1", "inference.nan_guard=true",
                          "inference.queue_limit=3"]
PARITY_PRIORITIES = (1, 0, 2, 0, 1)
PARITY_POOL_STEP = 5
PARITY_OUTCOMES = {"completed": 2, "shed": 4, "error:nan": 1, "cancelled": 2, "expired": 1}


def fault_prompts(n, seed, lo, hi, vocab=256):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, int(k)).tolist() for k in rng.integers(lo, hi, n)]


def parity_fault_drive(params, dev):
    """One run of the parity fault schedule on ``dev``: the typed outcome,
    stream and step of every request, the robustness counters, the faults
    fired and the launches (on cuda); then the max_step_faults run, which
    must re-raise DispatchFault."""
    from orion_tpu_torch import ops
    from orion_tpu_torch.config import get_config
    from orion_tpu_torch.infer import InferenceEngine
    from orion_tpu_torch.runtime.fault import DispatchFault, FaultInjector, FaultSpec

    cfg = get_config("tiny-llama", INFER_OVERRIDES + PARITY_FAULT_OVERRIDES)
    inj = FaultInjector([FaultSpec("nan", 2), FaultSpec("dispatch", 3, "decode"),
                         FaultSpec("pool", PARITY_POOL_STEP)])
    ops.reset_launches()
    eng = InferenceEngine(cfg, params, device=dev, fault_injector=inj)
    done = {}

    def step():
        n = eng.step_no
        for r in eng.step():
            done[r.rid] = (r.outcome, list(r.generated), n)

    first = [eng.submit_request(p, 12, priority=pr)
             for p, pr in zip(fault_prompts(5, 1, 3, 15), PARITY_PRIORITIES)]
    step()
    late = [eng.submit_request(p, 12) for p in fault_prompts(3, 2, 3, 15)]
    for _ in range(3):
        step()
    picks = {"cancel_waiting": eng.waiting[-1].rid,
             "cancel_active": max((r for r in eng.slots if r is not None and not r.done),
                                  key=lambda r: r.admit_seq).rid}
    eng.cancel(picks["cancel_waiting"])
    eng.cancel(picks["cancel_active"])
    step()
    expire = min((r for r in eng.slots if r is not None and not r.done), key=lambda r: r.rid)
    picks["expire"] = expire.rid
    expire.deadline = time.monotonic()
    while eng.step_no <= PARITY_POOL_STEP:
        step()
    tail = [eng.submit_request(p, 12) for p in fault_prompts(2, 3, 3, 15)]
    for r in eng.drain():
        done[r.rid] = (r.outcome, list(r.generated), eng.step_no)
    robust = {k: v for k, v in eng.reset_timing().items() if k in ROBUST_KEYS}
    launches = ops.launches() if dev == "cuda" else None
    eng.close()
    reqs = first + late + tail
    res = {"requests": [done[r.rid] for r in reqs], "robust": robust,
           "fired": list(inj.fired), "picks": picks}

    ladder = FaultInjector([FaultSpec("dispatch", s, count=10) for s in range(8)])
    eng = InferenceEngine(get_config("tiny-llama", INFER_OVERRIDES
                                     + ["inference.max_step_faults=2"]),
                          params, device=dev, fault_injector=ladder)
    for p in fault_prompts(3, 4, 3, 15):
        eng.submit_request(p, 12)
    try:
        while eng.has_work():
            eng.step()
        raise AssertionError(f"parity faults ({dev}): max_step_faults did not re-raise")
    except DispatchFault:
        pass
    res["ladder"] = {"step_no": eng.step_no, "robust": {
        k: v for k, v in eng.reset_timing().items() if k in ROBUST_KEYS}}
    return res, launches


def parity_faults(params):
    """The fault schedule on cuda (kernels) and on cpu (plain versions):
    typed outcomes, streams, the step each request surfaced at and every
    RobustnessStats counter must be equal, and the counters as scheduled.
    Returns the cuda run's launches."""
    got, launches = parity_fault_drive(params, "cuda")
    want, _ = parity_fault_drive(params, "cpu")
    if got != want:
        raise AssertionError(f"parity faults: cuda {got} != cpu {want}")
    outcomes = [o for o, _, _ in got["requests"]]
    rb = got["robust"]
    expect = {"shed_requests": 4, "quarantined_requests": 1, "cancelled_requests": 2,
              "expired_requests": 1, "dispatch_faults": 1, "failed_steps": 2,
              "pool_faults": 1}
    wrong = {k: rb[k] for k, v in expect.items() if rb[k] != v}
    counts = {o: outcomes.count(o) for o in set(outcomes)}
    if wrong or counts != PARITY_OUTCOMES or got["ladder"]["robust"]["failed_steps"] != 2:
        raise AssertionError(f"parity faults: counters off schedule {wrong}, outcomes "
                             f"{outcomes}, ladder {got['ladder']}")
    emit({"phase": "parity", "preset": "tiny-llama", "features": "fault_schedule",
          "equal": True, "outcomes": outcomes, "robust": rb, "fired": got["fired"],
          "picks": got["picks"], "ladder": got["ladder"], "launches": launches})
    return launches


def parity_chunked(params, pools):
    """tiny-llama with chunked prefill and the prefix cache, on cuda and on
    cpu: two waves sharing a two-page system prompt, the second repeating
    a page-multiple prompt of the first (its whole context cached: the
    copy-on-write admission). Returns the cuda run's launches."""
    import numpy as np

    from orion_tpu_torch import ops
    from orion_tpu_torch.config import get_config
    from orion_tpu_torch.infer import InferenceEngine

    quant = ["inference.kv_quant=int8"] if pools == "int8" else []
    cfg = get_config("tiny-llama", INFER_OVERRIDES + quant + [
        "inference.chunked_prefill=true", "inference.prefix_cache=true",
        "inference.prefill_chunk_tokens=32"])
    rng = np.random.default_rng(0)
    sys_prompt = rng.integers(1, 256, 32).tolist()
    wave1 = [sys_prompt + rng.integers(1, 256, n).tolist() for n in (16, 5, 37)]
    wave2 = [sys_prompt + rng.integers(1, 256, n).tolist() for n in (3, 20)] + [wave1[0]]
    streams, stats = {}, {}
    for dev in ("cuda", "cpu"):
        ops.reset_launches()
        eng = InferenceEngine(cfg, params, device=dev)
        streams[dev] = [eng.generate(wave1, 6), eng.generate(wave2, 6)]
        eng.assert_page_accounting()
        stats[dev] = eng.prefix_stats
        if dev == "cuda":
            launches = ops.launches()
    if streams["cuda"] != streams["cpu"]:
        raise AssertionError(f"tiny-llama chunked+prefix streams ({pools} pools) differ: "
                             f"cuda {streams['cuda']} cpu {streams['cpu']}")
    st = stats["cuda"]
    if st.hits < 3 or st.cow_pages < 1:
        raise AssertionError(f"parity ({pools} pools): expected prefix hits and a COW page, {st}")
    need = (("paged_prefill_int8", "paged_decode_int8") if pools == "int8"
            else ("paged_prefill", "paged_decode"))
    missing = [k for k in need + ("flash_fwd",) if launches[k] <= 0]
    if missing:
        raise AssertionError(f"parity ({pools} pools): kernels never launched: {missing}")
    emit({"phase": "parity", "preset": "tiny-llama", "features": "chunked_prefill+prefix_cache",
          "pools": pools, "equal": True, "prefix_hits": st.hits,
          "cow_pages": st.cow_pages, "cuda_streams": streams["cuda"], "launches": launches})
    return launches


SPEC_PARITY = {
    "chain": [],
    "tree": ["inference.spec_tree_width=2"],
    "tree_int8_chunked_prefix": ["inference.spec_tree_width=2", "inference.kv_quant=int8",
                                 "inference.chunked_prefill=true",
                                 "inference.prefix_cache=true",
                                 "inference.prefill_chunk_tokens=16"],
}
# The traffic of tests/test_spec_decode.py: cyclic prompts whose greedy
# continuations loop, so the n-gram drafter drafts.
SPEC_REP = [7, 8, 9, 7, 8, 9, 7, 8, 9, 7, 8]
SPEC_MIX = [SPEC_REP, [5, 3, 9, 250, 17], list(range(2, 32))]


def parity_spec(params, run):
    """tiny-llama float32 with speculation (greedy, decode_window 1), two
    waves of SPEC_MIX: the cuda streams must equal the cpu streams and the
    cuda spec-off streams, and the cuda speculation counters the cpu ones.
    Returns the speculating cuda run's launches."""
    import dataclasses

    from orion_tpu_torch import ops
    from orion_tpu_torch.config import get_config
    from orion_tpu_torch.infer import InferenceEngine

    base = INFER_OVERRIDES + ["inference.decode_window=1"] + SPEC_PARITY[run]
    spec = ["inference.speculative=true", "inference.speculate_tokens=4"]
    streams, stats = {}, {}
    for dev, on in (("cuda", True), ("cpu", True), ("cuda", False)):
        ops.reset_launches()
        eng = InferenceEngine(get_config("tiny-llama", base + (spec if on else [])), params,
                              device=dev)
        streams[dev, on] = [eng.generate(SPEC_MIX, 24), eng.generate(SPEC_MIX, 24)]
        eng.assert_page_accounting()
        stats[dev, on] = dataclasses.asdict(eng.spec_stats)
        if (dev, on) == ("cuda", True):
            launches = ops.launches()
    got = streams["cuda", True]
    if got != streams["cpu", True] or got != streams["cuda", False]:
        raise AssertionError(f"parity spec {run}: streams differ: cuda {got}, cpu "
                             f"{streams['cpu', True]}, cuda spec-off {streams['cuda', False]}")
    if stats["cuda", True] != stats["cpu", True]:
        raise AssertionError(f"parity spec {run}: counters differ: cuda {stats['cuda', True]} "
                             f"cpu {stats['cpu', True]}")
    st = stats["cuda", True]
    kernel = "ragged_verify_int8" if "int8" in run else "ragged_verify"
    if st["verify_steps"] < 1 or st["accepted"] < 1 or launches[kernel] < 1:
        raise AssertionError(f"parity spec {run}: nothing verified on {kernel}: {st}")
    emit({"phase": "parity", "preset": "tiny-llama", "features": f"speculative_{run}",
          "equal": True, "spec_stats": st, "cuda_streams": got, "launches": launches})
    return launches


def parity_constrained(params):
    """tiny-llama float32 with grammar-constrained decoding (chain
    speculation, decode window 1): a forced regex, a JSON schema and an
    unconstrained neighbour on cuda and on cpu; streams, outcomes and the
    ConstraintStats counters (the two times aside) must be equal. Returns
    the cuda run's launches."""
    import dataclasses

    from orion_tpu_torch import ops
    from orion_tpu_torch.config import get_config
    from orion_tpu_torch.constrain import ConstraintSpec, cache_clear
    from orion_tpu_torch.infer import InferenceEngine

    cfg = get_config("tiny-llama", INFER_OVERRIDES + [
        "inference.decode_window=1", "inference.constrained=true",
        "inference.speculative=true", "inference.speculate_tokens=4"])
    specs = [CON_SPECS[4], CON_SPECS[0], None]
    out = {}
    for dev in ("cuda", "cpu"):
        cache_clear()
        ops.reset_launches()
        eng = InferenceEngine(cfg, params, device=dev)
        reqs = [eng.submit_request(p, 32, constraint=None if s is None
                                   else ConstraintSpec(**{s[0]: s[1]}))
                for p, s in zip(SPEC_MIX, specs)]
        while eng.has_work():
            eng.step()
        stats = {k: v for k, v in dataclasses.asdict(eng.constraint_stats).items()
                 if k not in ("compile_s", "advance_s")}
        out[dev] = ([(r.outcome, list(r.generated)) for r in reqs], stats)
        if dev == "cuda":
            launches = ops.launches()
    if out["cuda"] != out["cpu"]:
        raise AssertionError(f"parity constrained: cuda {out['cuda']} != cpu {out['cpu']}")
    for r, s in zip(reqs, specs):
        if s is not None:
            check_grammar("parity constrained", r, s, None, 32)
    stats = out["cuda"][1]
    if stats["forced_drafted"] < 1 or launches["ragged_verify"] < 1:
        raise AssertionError(f"parity constrained: no forced draft or no K10 launch: {stats}")
    emit({"phase": "parity", "preset": "tiny-llama", "features": "constrained",
          "equal": True, "constrain": stats, "cuda_streams": out["cuda"][0],
          "launches": launches})
    return launches


# csrc/rmsnorm.cu's kernels by name, for the profile tables' groups (K5's
# scale-gradient finish, one sum over its partial rows, counts as "other").
RMSNORM_FWD_KERNELS = ["rmsnorm_fwd_kernel", "rmsnorm_fwd_generic_kernel"]
RMSNORM_BWD_KERNELS = ["rmsnorm_bwd_kernel", "rmsnorm_bwd_generic_kernel"]


def profile_drive(name, drive, groups):
    """Run ``drive()`` under torch.profiler: device time by kernel group
    (substring of the kernel's name -> group) and the device's idle share
    of the drive's wall time; the full table goes to
    chiprun_out/<name>_profile.txt."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        drive()
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
        for g, pats in groups.items():
            if any(pat in key for pat in pats):
                by_group[g] += us
                break
    by_group["other"] = busy - sum(by_group.values())
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"{name}_profile.txt"), "w") as f:
        for key, us, n in rows:
            f.write(f"{us / 1e3:12.3f} ms  {n:7d}  {key}\n")
    emit({"phase": f"{name}_profile", "wall_ms": wall_us / 1e3,
          "device_busy_ms": busy / 1e3, "device_idle_share": 1 - busy / wall_us,
          "device_ms_by_group": {g: us / 1e3 for g, us in by_group.items()},
          "top": [{"kernel": k[:80], "ms": us / 1e3, "count": n} for k, us, n in rows[:12]]})


def profile_serve(eng, prompts):
    """Drive the same requests again under torch.profiler."""

    def drive():
        for p in prompts:
            eng.submit_request(p, 64)
        while eng.has_work():
            eng.step()

    profile_drive("serve", drive, {
        "rmsnorm_fwd": RMSNORM_FWD_KERNELS, "rope_fwd": ["_rope_fwd"],
        "flash_fwd": ["flash_fwd_kernel", "flash_fwd_tc_kernel"],
        "paged_decode": ["paged_decode_kernel", "paged_decode_tc_kernel"],
        "paged_decode_merge": ["paged_decode_merge_kernel"],
        "GEMMs (cuBLAS)": ["gemm", "nvjet", "xmma", "cutlass", "splitKreduce"]})


def profile_train(tr, state, steps=2):
    """Run ``steps`` more training steps under torch.profiler."""

    def drive():
        for i in range(steps):
            tr.train_step(state, tr.global_batch(i))

    profile_drive("train", drive, {
        "rmsnorm (K1 + K5)": RMSNORM_FWD_KERNELS + RMSNORM_BWD_KERNELS,
        "rope (K2 + K6)": ["_rope_fwd"],
        "flash_fwd (K3)": ["flash_fwd_kernel", "flash_fwd_tc_kernel"],
        "flash_dq (K7)": ["flash_dq_kernel", "flash_dq_tc_kernel"],
        "flash_dkv (K8)": ["flash_dkv_kernel", "flash_dkv_tc_kernel"],
        "GEMMs (cuBLAS)": ["gemm", "nvjet", "xmma", "cutlass", "splitKreduce"],
    })


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
    missing = [k for k in SERVE_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched in the serve: {missing}")
    require_no_faults(eng, "serve")
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
        "launches": launches, "graphs": graph_stats(eng),
    })
    if profile:
        profile_serve(eng, prompts)
    return launches, eng.params   # serve_chunked reuses the weights


def free_engine():
    """Free a serve phase's engine and its KV pool: the phase's finiteness
    wrapper of ``eng._sample`` closes a reference cycle through the
    engine, which only the cycle collector breaks."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def serve_wave(eng, prompts, n_new, on_step=None):
    """Submit ``prompts`` together and drain the engine: the requests and
    the wave's numbers (timing and prefix-cache deltas, TTFT, rates, peak
    memory, launches). Prefill and decode rates divide by the time of the
    dispatches that carry that work: under chunked prefill every prompt
    token is computed in a mixed step, which carries decode rows too."""
    import dataclasses

    import torch

    from orion_tpu_torch import ops

    tm0, st0 = dict(eng.timing), dataclasses.asdict(eng.prefix_stats)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    reqs = [eng.submit_request(p, n_new) for p in prompts]
    while eng.has_work():
        eng.step()
        if on_step is not None:
            on_step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tm = {k: eng.timing[k] - tm0[k] for k in tm0}
    st = {k: v - st0[k] for k, v in dataclasses.asdict(eng.prefix_stats).items()}
    V = eng.mcfg.vocab_size
    for r in reqs:
        if not (r.done and r.outcome == "completed" and len(r.generated) == n_new):
            raise AssertionError(f"request {r.rid}: outcome {r.outcome!r}, "
                                 f"{len(r.generated)} tokens")
        if not all(0 <= t < V for t in r.generated):
            raise AssertionError(f"request {r.rid}: token outside the vocab")
    ttft = sorted(r.t_first - r.t_submit for r in reqs)
    decode_tokens = sum(len(r.generated) - 1 for r in reqs)
    busy_prefill = tm["prefill_s"] + tm["mixed_s"]
    return reqs, {
        "requests": len(reqs), "prompt_tokens": sum(map(len, prompts)),
        "new_tokens_each": n_new, "wall_s": wall,
        "ttft_s_median": statistics.median(ttft), "ttft_s_max": ttft[-1],
        "prefill_tokens": tm["prefill_tokens"],
        "prefill_tok_s": tm["prefill_tokens"] / busy_prefill if busy_prefill else None,
        "decode_tokens": decode_tokens,
        "decode_tok_s": decode_tokens / (tm["decode_s"] + tm["mixed_s"]),
        "prefill_s": tm["prefill_s"], "mixed_s": tm["mixed_s"], "decode_s": tm["decode_s"],
        **{k: tm[k] for k in ("mixed_steps", "prefill_chunks", "chunk_tokens",
                              "chunk_pad_tokens", "steps", "verify_steps",
                              "mixed_verify_steps", "verify_s")},
        "prefix": {k: st[k] for k in ("hits", "misses", "cached_tokens", "cow_pages",
                                      "inserted_pages", "evicted_pages")},
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": ops.launches(), "graphs": graph_stats(eng),
    }


def phase_serve_chunked(profile=False, params=None):
    """llama3-8b-infer with int8 KV, the prefix cache and chunked prefill:
    two waves of 8 requests sharing a 1024-token system prompt; on the
    serve phase's ``params`` when given, else on fresh seeded weights."""
    import numpy as np
    import torch

    from orion_tpu_torch.config import get_config
    from orion_tpu_torch.infer import InferenceEngine
    from orion_tpu_torch.metrics import PrefixCacheStats
    from orion_tpu_torch.models import init_params

    cfg = get_config("llama3-8b-infer", SERVE_CHUNKED_OVERRIDES)
    V, psz = cfg.model.vocab_size, cfg.inference.page_size
    t0 = time.perf_counter()
    if params is None:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
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
    sys_prompt = rng.integers(0, V, 1024).tolist()
    tails = rng.integers(100, 1001, 15)
    tails[0] = tails[0] // psz * psz      # a page-multiple prompt, repeated in wave 2
    prompts = [sys_prompt + rng.integers(0, V, n).tolist() for n in tails]
    waves = (prompts[:8], prompts[8:] + prompts[:1])
    # Warm-up, as a server does at start: one 300-token request (a first
    # chunk, then one resuming over its pages) compiles the Triton kernels
    # and settles cuBLAS; its cached pages are dropped again.
    eng.generate([rng.integers(0, V, 300).tolist()], 2)
    eng.clear_prefix_cache()
    eng.timing = {k: 0 for k in eng.timing}
    eng.prefix_stats = PrefixCacheStats()
    finite.clear()
    totals = {}
    for i, wave in enumerate(waves, 1):
        _, res = serve_wave(eng, wave, 64)
        for k, n in res["launches"].items():
            totals[k] = totals.get(k, 0) + n
        emit({"phase": "serve_chunked", "preset": "llama3-8b-infer",
              "overrides": SERVE_CHUNKED_OVERRIDES, "wave": i, "setup_s": setup_s, **res})
    st = eng.prefix_stats
    if not (finite and all(finite)):
        raise AssertionError("serve_chunked: non-finite prefill logits")
    if st.hits < 8 or st.cached_tokens < 8 * 1024 or st.cow_pages < 1:
        raise AssertionError(f"serve_chunked: too few prefix hits or no COW page: {st}")
    missing = [k for k in SERVE_CHUNKED_KERNELS if totals[k] <= 0]
    if missing:
        raise AssertionError(f"serve_chunked: kernels never launched: {missing}")
    require_no_faults(eng, "serve_chunked")
    eng.assert_page_accounting()
    if profile:
        # A third wave like the second (the system prompt cached, new tails).
        third = [sys_prompt + rng.integers(0, V, n).tolist()
                 for n in rng.integers(100, 1001, 8)]
        profile_drive("serve_chunked", lambda: serve_wave(eng, third, 64), {
            "rmsnorm_fwd": RMSNORM_FWD_KERNELS, "rope_fwd": ["_rope_fwd"],
            "flash_fwd": ["flash_fwd_kernel", "flash_fwd_tc_kernel"],
            "paged_decode_int8": ["paged_decode_kernel", "paged_decode_tc_kernel"],
            "paged_decode_merge": ["paged_decode_merge_kernel"],
            "paged_prefill_int8": ["paged_prefill_kernel", "paged_prefill_tc_kernel"],
            "paged_prefill_merge": ["paged_prefill_merge_kernel"],
            "GEMMs (cuBLAS)": ["gemm", "nvjet", "xmma", "cutlass", "splitKreduce"]})
    released = eng.clear_prefix_cache()
    if eng.alloc.free_pages != cfg.inference.num_pages - 1:
        raise AssertionError(f"serve_chunked: {eng.alloc.free_pages} free pages after "
                             f"clear_prefix_cache(), want {cfg.inference.num_pages - 1}")
    emit({"phase": "serve_chunked", "prefix_totals": {
        "hits": st.hits, "misses": st.misses, "cached_tokens": st.cached_tokens,
        "cow_pages": st.cow_pages}, "released_on_clear": released,
        "free_pages": eng.alloc.free_pages, "launches": totals})
    return totals


SERVE_SPEC_DRIVES = {
    "A": ["inference.speculative=true", "inference.prefix_cache=true"],
    "A0": ["inference.prefix_cache=true"],
    "B": ["inference.speculative=true", "inference.spec_tree_width=2",
          "inference.kv_quant=int8", "inference.prefix_cache=true",
          "inference.chunked_prefill=true"],
}
SERVE_SPEC_KERNELS = {"A": ("ragged_verify", "ragged_verify_merge"),
                      "A0": ("paged_decode", "paged_decode_merge"),
                      "B": ("ragged_verify_int8", "ragged_verify_merge", "paged_prefill_int8",
                            "paged_decode_int8", "paged_decode_merge")}


def serve_spec_drive(name, params, prompts, profile=False):
    """One drive of serve_spec: an engine with SERVE_SPEC_DRIVES[name],
    a warm-up, then the two waves (the same prompts twice); with
    ``profile``, a third wave like the second under torch.profiler.
    Returns the waves' requests and numbers and the totals of launches."""
    import dataclasses

    import numpy as np
    import torch

    from orion_tpu_torch.config import get_config
    from orion_tpu_torch.infer import InferenceEngine

    cfg = get_config("llama3-8b-infer", SERVE_SPEC_DRIVES[name])
    V = cfg.model.vocab_size
    eng = InferenceEngine(cfg, params, device="cuda")
    finite = []
    sample = eng._sample

    def checked_sample(logits, reqs):
        finite.append(bool(torch.isfinite(logits[: len(reqs)]).all()))
        return sample(logits, reqs)

    eng._sample = checked_sample
    # Warm-up, as a server does at start: a 300-token request, then the
    # same again (it drafts from the first one's cached path, so verify
    # steps run) beside a 600-token one (its chunks ride mixed verify
    # steps under chunked prefill); the cached pages are dropped again.
    rng = np.random.default_rng(1)
    warm = rng.integers(0, V, 300).tolist()
    eng.generate([warm], 40)
    eng.generate([warm, rng.integers(0, V, 600).tolist()], 40)
    eng.clear_prefix_cache()
    eng.reset_timing()
    finite.clear()
    waves, totals = [], {}
    for i in (1, 2):
        st0 = dataclasses.asdict(eng.spec_stats)
        reqs, res = serve_wave(eng, prompts, 64)
        st = {k: v - st0[k] for k, v in dataclasses.asdict(eng.spec_stats).items()
              if isinstance(v, int)}
        res.update(
            spec={"drafted": st["drafted"], "accepted": st["accepted"],
                  "rolled_back": st["rolled_back"], "gated_steps": st["gated_steps"],
                  "acceptance_rate": st["accepted"] / st["drafted"] if st["drafted"] else 0.0,
                  "emitted_per_verify_slot_step": (st["emitted"] / st["verify_slot_steps"]
                                                   if st["verify_slot_steps"] else 0.0),
                  "verify_slot_steps": st["verify_slot_steps"], "tree_nodes": st["tree_nodes"],
                  "tree_branch_nodes": st["tree_branch_nodes"],
                  "compactions": st["compactions"]})
        eng.assert_page_accounting()
        for k, n in res["launches"].items():
            totals[k] = totals.get(k, 0) + n
        waves.append((reqs, res))
    if not (finite and all(finite)):
        raise AssertionError(f"serve_spec {name}: non-finite prefill logits")
    require_no_faults(eng, f"serve_spec {name}")
    if profile:
        profile_drive(f"serve_spec_{name}", lambda: serve_wave(eng, prompts, 64), {
            "rmsnorm_fwd": RMSNORM_FWD_KERNELS, "rope_fwd": ["_rope_fwd"],
            "flash_fwd": ["flash_fwd_kernel", "flash_fwd_tc_kernel"],
            "paged_decode (K4)": ["paged_decode_kernel", "paged_decode_tc_kernel",
                                  "paged_decode_merge_kernel"],
            "paged_prefill (K9)": ["paged_prefill_kernel", "paged_prefill_tc_kernel",
                                   "paged_prefill_merge_kernel"],
            "ragged_verify (K10)": ["ragged_verify_kernel", "ragged_verify_tc_kernel",
                                    "ragged_verify_merge_kernel"],
            "GEMMs (cuBLAS)": ["gemm", "nvjet", "xmma", "cutlass", "splitKreduce"]})
    eng.clear_prefix_cache()
    if eng.alloc.free_pages != cfg.inference.num_pages - 1:
        raise AssertionError(f"serve_spec {name}: {eng.alloc.free_pages} free pages after "
                             f"clear_prefix_cache(), want {cfg.inference.num_pages - 1}")
    return waves, totals


def phase_serve_spec(params=None, profile=False):
    """llama3-8b-infer at full width and depth with speculative decoding:
    two waves of 8 greedy requests of 100-1000 random prompt tokens (numpy
    seed 0; one prompt a page multiple), the second wave the same prompts
    again (a regenerated answer: the first wave's prompt + answer pages sit
    in the prefix tree and are the drafter's source), 64 new tokens each.
    Drives A (chain, bf16 pools, prefix cache), A0 (A without speculation)
    and B (tree width 2, int8 pools, prefix cache, chunked prefill), on the
    serve phase's ``params`` when given, else on fresh seeded weights."""
    import numpy as np
    import torch

    from orion_tpu_torch.config import get_config
    from orion_tpu_torch.models import init_params

    cfg = get_config("llama3-8b-infer")
    V, psz = cfg.model.vocab_size, cfg.inference.page_size
    if params is None:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        params = init_params(cfg.model, gen, device="cuda", dtype="bfloat16")
    rng = np.random.default_rng(0)
    lens = rng.integers(100, 1001, 8)
    lens[0] = lens[0] // psz * psz
    prompts = [rng.integers(0, V, n).tolist() for n in lens]
    streams, totals = {}, {}
    for name in SERVE_SPEC_DRIVES:
        waves, totals[name] = serve_spec_drive(name, params, prompts, profile)
        streams[name] = [[r.generated for r in reqs] for reqs, _ in waves]
        for i, (_, res) in enumerate(waves, 1):
            emit({"phase": "serve_spec", "drive": name, "overrides": SERVE_SPEC_DRIVES[name],
                  "wave": i, **res})
        free_engine()
        _, w2 = waves[1]
        if name != "A0" and w2["verify_steps"] < 1:
            raise AssertionError(f"serve_spec {name}: no verify step in wave 2")
        if name == "A" and w2["spec"]["accepted"] < 1:
            raise AssertionError("serve_spec A: no draft accepted in wave 2")
        missing = [k for k in SERVE_SPEC_KERNELS[name] if totals[name][k] <= 0]
        if missing:
            raise AssertionError(f"serve_spec {name}: kernels never launched: {missing}")
    # bf16 verify and decode run GEMMs of other shapes: reported, not gated.
    same = [sum(a == b for a, b in zip(wa, wb)) for wa, wb in zip(streams["A"], streams["A0"])]
    emit({"phase": "serve_spec", "streams_A_equal_A0_per_wave": same,
          "requests_per_wave": len(prompts), "launches": totals})
    return {k: sum(t[k] for t in totals.values()) for k in totals["A"]}


# serve_faults: llama3-8b-infer at full width and depth on the serve's
# weights, four drives. F1 and F4 share SERVE_F1_OVERRIDES and the schedule
# of serve_f1 (F4 cancels F1's NaN victim right after step 3 instead of
# poisoning it); F2 is the chunked serve's configuration with the guard;
# F3 the speculative serve's drive A.
SERVE_F1_OVERRIDES = ["inference.nan_guard=true", "inference.max_batch_size=8",
                      "inference.queue_limit=8"]
SERVE_F2_OVERRIDES = SERVE_CHUNKED_OVERRIDES + ["inference.nan_guard=true"]
F1_OUTCOMES = {"completed": 12, "shed": 4, "error:nan": 1, "cancelled": 2, "expired": 1}
F4_OUTCOMES = {"completed": 12, "shed": 4, "cancelled": 3, "expired": 1}


def require_no_faults(eng, where):
    """A phase without injected faults must have contained none: a real
    kernel failure that the envelope absorbed would otherwise pass."""
    rb = eng.robust
    if rb.dispatch_faults or rb.failed_steps or rb.pool_faults:
        raise AssertionError(f"{where}: {rb.dispatch_faults} dispatch faults, "
                             f"{rb.failed_steps} failed steps, {rb.pool_faults} pool faults")


def graph_stats(eng):
    """The engine's dispatch programs: CUDA graphs captured and replayed,
    capture seconds and the graph pool's bytes."""
    ex = eng._executor
    return {"cuda_graphs": ex.graphs, "captures": ex.captures, "replays": ex.replays,
            "capture_s": ex.capture_s, "pool_bytes": ex.pool_bytes}


def rule_sheds(queued, arrivals, limit):
    """The documented overload rule, restated: with the queue at ``limit``,
    an arrival sheds the lowest priority, then the newest, among the
    queued never-run requests and itself. ``queued``/``arrivals`` are
    (rid, priority) pairs (no deadlines); returns the rids shed."""
    q, shed = list(queued), []
    for rid, pr in arrivals:
        if len(q) < limit:
            q.append((rid, pr))
            continue
        victim = min(q + [(rid, pr)], key=lambda t: (t[1], -t[0]))
        shed.append(victim[0])
        if victim[0] != rid:
            q.remove(victim)
            q.append((rid, pr))
    return shed


def fault_line(name, eng, reqs, t0, launches, **extra):
    """The drive's JSON line: outcome counts, the robustness counters,
    launches per kernel, wall seconds and the card."""
    outcomes = [r.outcome for r in reqs]
    line = {"phase": "serve_faults", "drive": name, "preset": "llama3-8b-infer",
            "outcomes": {o: outcomes.count(o) for o in sorted(set(outcomes))},
            "robust": {k: v for k, v in eng.reset_timing().items() if k in ROBUST_KEYS},
            "launches": launches, "wall_s": time.perf_counter() - t0,
            "nvidia_smi": smi_line(), **extra}
    emit(line)
    return line


def serve_f1(params, nan):
    """F1 (``nan``) or F4: bf16 pool, the guard, 8 slots, a queue of 8. 8
    greedy requests of 100-1000 prompt tokens (numpy seed 0), 64 new tokens
    each, admitted at step 0; then 10 more with priorities cycling 0/1/2
    (the rule sheds two). A NaN at step 3 (F1; F4 cancels the same oldest
    request right after step 3), a decode dispatch fault at step 5, a cancel
    of the newest waiting and the youngest active request after step 6, the
    youngest active request's deadline set to now after step 8; once the
    queue is empty, two more submissions and drain()."""
    import numpy as np
    import torch

    from orion_tpu_torch import ops
    from orion_tpu_torch.config import get_config
    from orion_tpu_torch.infer import InferenceEngine
    from orion_tpu_torch.runtime.fault import FaultInjector, FaultSpec

    cfg = get_config("llama3-8b-infer", SERVE_F1_OVERRIDES)
    V = cfg.model.vocab_size
    specs = [FaultSpec("dispatch", 5, "decode")] + ([FaultSpec("nan", 3)] if nan else [])
    inj = FaultInjector(specs)
    eng = InferenceEngine(cfg, params, device="cuda", fault_injector=inj)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, V, n).tolist() for n in rng.integers(100, 1001, 20)]
    done, first_seq = {}, {}

    def step():
        n = eng.step_no
        for r in eng.step():
            done[r.rid] = n
        for r in eng.slots:
            if r is not None and r.rid not in first_seq:
                first_seq[r.rid] = r.admit_seq

    ops.reset_launches()
    t0 = time.perf_counter()
    wave1 = [eng.submit_request(p, 64) for p in prompts[:8]]
    step()
    if any(r.slot is None for r in wave1):
        raise AssertionError("serve_faults F1: the first 8 requests were not all admitted")
    wave2 = [eng.submit_request(p, 64, priority=i % 3) for i, p in enumerate(prompts[8:18])]
    shed_now = [r.rid for r in wave2 if r.outcome == "shed"]
    want_shed = rule_sheds([], [(r.rid, r.priority) for r in wave2], 8)
    picks = {"victim": min(wave1, key=lambda r: r.admit_seq).rid}
    while eng.step_no < 9:
        if eng.step_no == 4 and not nan:
            eng.cancel(picks["victim"])
        if eng.step_no == 7:
            live = [r for r in eng.slots if r is not None and not r.done]
            picks["cancel_waiting"] = eng.waiting[-1].rid
            picks["cancel_active"] = max(live, key=lambda r: r.admit_seq).rid
            eng.cancel(picks["cancel_waiting"])
            eng.cancel(picks["cancel_active"])
        step()
    live = [r for r in eng.slots if r is not None and not r.done
            and 0 < len(r.generated) < 64]
    expire = max(live, key=lambda r: r.admit_seq)
    picks["expire"] = expire.rid
    expire.deadline = time.monotonic()
    while eng.waiting:
        step()
    tail = [eng.submit_request(p, 64) for p in prompts[18:]]
    for r in eng.drain():
        done[r.rid] = eng.step_no
    torch.cuda.synchronize()
    launches = ops.launches()
    reqs = wave1 + wave2 + tail
    by_rid = {r.rid: r for r in reqs}
    admitted2 = [r for r in wave2 if r.rid in first_seq]
    order = [r.rid for r in sorted(admitted2, key=lambda r: first_seq[r.rid])]
    want_order = [r.rid for r in sorted(admitted2, key=lambda r: (-r.priority, r.rid))]
    line = fault_line("F1" if nan else "F4", eng, reqs, t0, launches, picks=picks,
                      shed_on_arrival=shed_now, admission_order=order,
                      expired_tokens=len(expire.generated))
    eng.close()
    want = F1_OUTCOMES if nan else F4_OUTCOMES
    bad = []
    if line["outcomes"] != want:
        bad.append(f"outcomes {line['outcomes']} != {want}")
    if shed_now != want_shed:
        bad.append(f"shed on arrival {shed_now}, the rule sheds {want_shed}")
    if order != want_order:
        bad.append(f"admission order {order}, by priority then arrival {want_order}")
    victim = by_rid[picks["victim"]]
    if nan and (victim.outcome != "error:nan" or done[victim.rid] != 3):
        bad.append(f"victim {victim.rid}: {victim.outcome} at step {done.get(victim.rid)}")
    if not 0 < len(expire.generated) < 64 or expire.outcome != "expired":
        bad.append(f"expired request: {expire.outcome}, {len(expire.generated)} tokens")
    if any(r.outcome != "shed" for r in tail):
        bad.append("drain did not shed the never-started submissions")
    if any(len(r.generated) != 64 for r in reqs if r.outcome == "completed"):
        bad.append("a completed request without 64 tokens")
    rb = line["robust"]
    if rb["dispatch_faults"] != 1 or rb["failed_steps"] != 1 or rb["pool_faults"]:
        bad.append(f"fault counters {rb}")
    if rb["quarantined_requests"] != int(nan) or rb["shed_requests"] != 4:
        bad.append(f"outcome counters {rb}")
    missing = [k for k in SERVE_KERNELS if launches[k] <= 0]
    if bad or missing:
        raise AssertionError(f"serve_faults {line['drive']}: {bad}, never launched {missing}")
    return {r.rid: (r.outcome, list(r.generated)) for r in reqs}, launches


def serve_f2(params):
    """F2: the chunked serve's configuration (int8 pool, prefix cache,
    chunked prefill) with the guard; 8 greedy requests sharing a 1024-token
    system prompt, 64 new tokens each. A NaN in the first request to finish
    its prompt (mid-decode: K4-int8 reads the poisoned k_scale rows) and a
    NaN in the last request once its first chunk is in the pool (its next
    chunks read the poisoned history through K9-int8; caught at its first
    guarded step, the decode step after its last chunk)."""
    import numpy as np
    import torch

    from orion_tpu_torch import ops
    from orion_tpu_torch.config import get_config
    from orion_tpu_torch.infer import InferenceEngine
    from orion_tpu_torch.runtime.fault import FaultInjector, FaultSpec

    cfg = get_config("llama3-8b-infer", SERVE_F2_OVERRIDES)
    V = cfg.model.vocab_size
    inj = FaultInjector()
    eng = InferenceEngine(cfg, params, device="cuda", fault_injector=inj)
    rng = np.random.default_rng(0)
    sys_prompt = rng.integers(0, V, 1024).tolist()
    prompts = [sys_prompt + rng.integers(0, V, n).tolist() for n in rng.integers(100, 1001, 8)]
    ops.reset_launches()
    t0 = time.perf_counter()
    reqs = [eng.submit_request(p, 64) for p in prompts]
    dec_victim = pre_victim = None
    surfaced, prefill_end = {}, None
    while eng.has_work():
        if dec_victim is None:
            dec_victim = next((r for r in reqs if r.slot is not None and r.generated
                               and not r.prefill_pending), None)
            if dec_victim is not None:
                inj.specs.append(FaultSpec("nan", eng.step_no, rid=dec_victim.rid))
        if pre_victim is None and reqs[-1].prefill_pending and reqs[-1].prefill_done > 0:
            pre_victim = reqs[-1]
            inj.specs.append(FaultSpec("nan", eng.step_no, rid=pre_victim.rid))
        pending = pre_victim is not None and pre_victim.prefill_pending
        n = eng.step_no
        for r in eng.step():
            surfaced[r.rid] = n
        if pending and not pre_victim.prefill_pending and prefill_end is None:
            prefill_end = n
    torch.cuda.synchronize()
    launches = ops.launches()
    victims = [r for r in (dec_victim, pre_victim) if r is not None]
    cached = {r.rid: eng.prefix_match_tokens(r.prompt) for r in victims}
    eng.assert_page_accounting()
    line = fault_line("F2", eng, reqs, t0, launches, fired=list(inj.fired),
                      victims={r.rid: surfaced[r.rid] for r in victims},
                      prefill_victim_last_chunk_step=prefill_end,
                      victim_cached_tokens=cached)
    eng.clear_prefix_cache()
    free = eng.alloc.free_pages
    eng.close()
    bad = []
    if len(victims) != 2 or any(r.outcome != "error:nan" for r in victims):
        bad.append(f"victims {[(r.rid, r.outcome) for r in victims]}")
    elif surfaced[pre_victim.rid] != prefill_end + 1:
        bad.append(f"prefill victim caught at step {surfaced[pre_victim.rid]}, its last "
                   f"chunk at {prefill_end}")
    if any(n > 1024 for n in cached.values()):
        bad.append(f"a victim's pages reached the prefix cache: {cached}")
    if any(r.outcome != "completed" or len(r.generated) != 64
           for r in reqs if r not in victims):
        bad.append("a neighbour did not complete")
    if free != cfg.inference.num_pages - 1:
        bad.append(f"{free} free pages after clear_prefix_cache()")
    rb = line["robust"]
    if rb["quarantined_requests"] != 2 or rb["dispatch_faults"] or rb["failed_steps"]:
        bad.append(f"counters {rb}")
    need = ("paged_decode_int8", "paged_prefill_int8")
    missing = [k for k in need if launches[k] <= 0]
    if bad or missing:
        raise AssertionError(f"serve_faults F2: {bad}, never launched {missing}")
    return launches


def serve_f3(params):
    """F3: the speculative serve's drive A (chain, bf16 pools, prefix
    cache): a clean wave of 8, then the same 8 again; once two of wave 2's
    verify steps have run on K10, verify dispatch faults are scheduled at
    every step; the third (spec_fault_limit) switches speculation off,
    after which K10 no longer launches and K4 does."""
    import numpy as np
    import torch

    from orion_tpu_torch import ops
    from orion_tpu_torch.config import get_config
    from orion_tpu_torch.infer import InferenceEngine
    from orion_tpu_torch.runtime.fault import FaultInjector, FaultSpec

    cfg = get_config("llama3-8b-infer", SERVE_SPEC_DRIVES["A"])
    V, psz = cfg.model.vocab_size, cfg.inference.page_size
    inj = FaultInjector()
    eng = InferenceEngine(cfg, params, device="cuda", fault_injector=inj)
    rng = np.random.default_rng(0)
    lens = rng.integers(100, 1001, 8)
    lens[0] = lens[0] // psz * psz
    prompts = [rng.integers(0, V, n).tolist() for n in lens]
    ops.reset_launches()
    t0 = time.perf_counter()
    wave1 = [eng.submit_request(p, 64) for p in prompts]
    while eng.has_work():
        eng.step()
    require_no_faults(eng, "serve_faults F3 wave 1")
    limit = cfg.inference.spec_fault_limit
    wave2 = [eng.submit_request(p, 64) for p in prompts]
    v0 = eng.spec_stats.verify_steps
    while eng.has_work() and eng.spec_stats.verify_steps < v0 + 2:
        eng.step()
    inj.specs.extend(FaultSpec("dispatch", s, "verify") for s in range(eng.step_no,
                                                                         eng.step_no + 64))
    at_disable = None
    while eng.has_work():
        eng.step()
        if at_disable is None and eng.spec_stats.disabled_reason:
            at_disable = dict(ops.launches(), step=eng.step_no - 1)
    torch.cuda.synchronize()
    launches = ops.launches()
    eng.assert_page_accounting()
    fired = [s for _, s, _ in inj.fired]
    reqs = wave1 + wave2
    line = fault_line("F3", eng, reqs, t0, launches, fired_steps=fired,
                      disabled_reason=eng.spec_stats.disabled_reason,
                      launches_at_disable=at_disable)
    eng.close()
    bad = []
    if at_disable is None or len(fired) != limit or at_disable["step"] != fired[-1]:
        bad.append(f"speculation not disabled at the {limit}th fault: fired at {fired}, "
                   f"disabled after {at_disable and at_disable['step']}")
    elif fired != list(range(fired[0], fired[0] + limit)):
        bad.append(f"faults at steps {fired}, not consecutive")
    elif (at_disable["ragged_verify"] <= 0
          or launches["ragged_verify"] != at_disable["ragged_verify"]
          or launches["paged_decode"] <= at_disable["paged_decode"]):
        bad.append("K10 did not launch before speculation was disabled, or launched "
                   "after it, or K4 did not launch after it")
    if any(r.outcome != "completed" or len(r.generated) != 64 for r in reqs):
        bad.append("a request did not complete")
    rb = line["robust"]
    if rb["failed_steps"] != len(fired) or rb["dispatch_faults"] != len(fired):
        bad.append(f"counters {rb}")
    if bad:
        raise AssertionError(f"serve_faults F3: {bad}")
    return launches


def phase_serve_faults(params=None):
    """llama3-8b-infer at full width and depth with the lifecycle and fault
    containment: drives F1-F4 (see serve_f1, serve_f2, serve_f3) on the
    serve phase's ``params`` when given, else on fresh seeded weights. F4's
    streams must equal F1's, byte for byte, for every request that completes
    in both. Returns the launches of the four drives together."""
    import torch

    from orion_tpu_torch.config import get_config
    from orion_tpu_torch.models import init_params

    if params is None:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        params = init_params(get_config("llama3-8b-infer").model, gen, device="cuda",
                             dtype="bfloat16")
    totals = {}

    def add(launches):
        for k, n in launches.items():
            totals[k] = totals.get(k, 0) + n

    sticky_error_row()
    f1, launches = serve_f1(params, nan=True)
    add(launches)
    free_engine()
    add(serve_f2(params))
    free_engine()
    add(serve_f3(params))
    free_engine()
    f4, launches = serve_f1(params, nan=False)
    add(launches)
    free_engine()
    both = [rid for rid in f1 if f1[rid][0] == "completed" and f4[rid][0] == "completed"]
    differ = [rid for rid in both if f1[rid][1] != f4[rid][1]]
    emit({"phase": "serve_faults", "f4_vs_f1": {"completed_in_both": len(both),
                                                "streams_differ": differ}})
    if differ or len(both) != F1_OUTCOMES["completed"]:
        raise AssertionError(f"serve_faults F4: neighbour streams differ from F1: {differ} "
                             f"({len(both)} completed in both)")
    return totals


# serve_faults' sticky-error row: a tiny-llama bf16 engine in a process of
# its own (a device-side assert poisons the CUDA context for the life of
# the process), 6 greedy requests; at engine step STICKY_STEP the decode
# dispatch's launch (the executor's ``launch``: the replay of the window's
# CUDA graph) is wrapped so that, right after the replay is queued and
# before the host fetch, inside the step's envelope, an out-of-range index
# into a CUDA tensor launches a device-side assert. The child ends with one JSON report within
# STICKY_TIMEOUT_S or the row fails.
STICKY_STEP = 2
STICKY_TIMEOUT_S = 120


def sticky_child() -> int:
    """The sticky-error drive, run by ``sticky_error_row`` as
    ``python3 -c "import chip_smoke; chip_smoke.sticky_child()"``: prints one
    JSON line (each failed step's logged error, the robustness counters,
    the step at which the engine re-raised and what the caller got, every
    request's outcome and token counts) and exits without tearing the
    poisoned context down."""
    import logging

    import torch

    sys.path.insert(0, HERE)
    from orion_tpu_torch.config import get_config
    from orion_tpu_torch.infer import InferenceEngine
    from orion_tpu_torch.models import init_params

    class Errors(logging.Handler):
        def __init__(self):
            super().__init__(logging.ERROR)
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage()[:400])

    errors = Errors()
    logging.getLogger("orion_tpu_torch.infer").addHandler(errors)
    cfg = get_config("tiny-llama", INFER_OVERRIDES + ["model.dtype=bfloat16"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_params(cfg.model, gen, device="cuda", dtype="bfloat16")
    eng = InferenceEngine(cfg, params, device="cuda")
    real = eng._executor.launch
    launched = []

    def replay_then_assert(path, *args, **kwargs):
        out = real(path, *args, **kwargs)
        if path == "decode" and eng.step_no == STICKY_STEP and not launched:
            launched.append(eng.step_no)
            x = torch.zeros(4, device="cuda")
            x[torch.full((1,), 1 << 20, dtype=torch.long, device="cuda")]   # device-side assert
        return out

    eng._executor.launch = replay_then_assert
    reqs = [eng.submit_request(p, 24) for p in fault_prompts(6, 5, 3, 15)]
    steps, caller, before = [], None, None
    while eng.has_work():
        n = eng.step_no
        if n == STICKY_STEP:
            before = [len(r.generated) for r in reqs]
        f0, e0 = eng.robust.failed_steps, len(errors.lines)
        try:
            eng.step()
        except Exception as e:   # what reaches the caller, recorded and reported
            caller = {"step": n, "type": type(e).__name__, "text": str(e)[:400]}
        steps.append({"step": n, "failed": eng.robust.failed_steps > f0 or caller is not None,
                      "errors": errors.lines[e0:]})
        if caller is not None:
            break
    rb = eng.robust
    report = {"sticky_step": STICKY_STEP, "assert_launched_at": launched,
              "max_step_faults": eng.icfg.max_step_faults,
              "steps": [s for s in steps if s["failed"]],
              "ok_steps": [s["step"] for s in steps if not s["failed"]],
              "dispatch_faults": rb.dispatch_faults, "failed_steps": rb.failed_steps,
              "caller": caller, "outcomes": [r.outcome for r in reqs],
              "tokens_before_fault": before, "tokens_at_end": [len(r.generated) for r in reqs]}
    print(json.dumps(report), flush=True)
    sys.stderr.flush()
    os._exit(0)


def sticky_error_row():
    """serve_faults' sticky-error row: run ``sticky_child`` in a subprocess
    (STICKY_TIMEOUT_S) and hold its report to the envelope's contract: the
    first failure is a contained decode DispatchFault at STICKY_STEP caused
    by the device-side assert, every later step fails too and is counted
    once, the engine re-raises DispatchFault after exactly
    inference.max_step_faults consecutive failed steps, and no token is
    appended after the fault."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", "import chip_smoke; chip_smoke.sticky_child()"],
                          cwd=HERE, capture_output=True, text=True, timeout=STICKY_TIMEOUT_S)
    wall = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "sticky_child.log"), "w") as f:
        f.write(proc.stdout + "\n== stderr\n" + proc.stderr)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"serve_faults sticky: child exited {proc.returncode} without a "
                             f"report: {proc.stderr[-2000:]}")
    rep = json.loads(lines[-1])
    m = rep["max_step_faults"]
    failed = [s["step"] for s in rep["steps"]]
    first = rep["steps"][0]["errors"] if rep["steps"] else []
    caller = rep["caller"] or {}
    bad = []
    if rep["assert_launched_at"] != [STICKY_STEP]:
        bad.append(f"assert launched at {rep['assert_launched_at']}")
    if failed != list(range(STICKY_STEP, STICKY_STEP + m)):
        bad.append(f"failed steps {failed}, want {STICKY_STEP}..{STICKY_STEP + m - 1}")
    if not any("decode dispatch failed" in e and "device-side assert" in e for e in first):
        bad.append(f"first failure not a contained decode fault of the assert: {first}")
    if rep["dispatch_faults"] != m or rep["failed_steps"] != m:
        bad.append(f"counted {rep['dispatch_faults']} dispatch faults, {rep['failed_steps']} "
                   f"failed steps for {m} failed steps")
    if caller.get("type") != "DispatchFault" or caller.get("step") != STICKY_STEP + m - 1:
        bad.append(f"caller got {caller}")
    if rep["tokens_at_end"] != rep["tokens_before_fault"]:
        bad.append(f"tokens appended after the fault: {rep['tokens_before_fault']} -> "
                   f"{rep['tokens_at_end']}")
    emit({"phase": "serve_faults", "drive": "sticky_error", "preset": "tiny-llama",
          "dtype": "bfloat16", "wall_s": wall, "nvidia_smi": smi_line(), **rep})
    if bad:
        raise AssertionError(f"serve_faults sticky: {bad}")


# serve_constrained: llama3-8b-infer at full width and depth (the serve's
# weights), bf16 pools and the prefix cache; eos = V - 1, which no byte
# token is, so eos passes a mask only in an accepting state. C1: 16 greedy
# requests of 100-1000 random prompt tokens (numpy seed 0), 64 new tokens
# each, 4 under a JSON schema and 4 under a regex (the patterns of
# tests/test_constrain.py), 8 unconstrained; A0 the same prompts with no
# constraint and constrained=false. C2: C1 with int8 pools, chunked
# prefill and tree speculation of width 2. C0: 8 more prompts,
# unconstrained, under constrained=true and under constrained=false (the
# same code path): byte-identical streams.
CON_OVERRIDES = ["inference.prefix_cache=true"]
CON_C2 = ["inference.kv_quant=int8", "inference.chunked_prefill=true",
          "inference.speculative=true", "inference.spec_tree_width=2"]
CON_SPECS = (
    [("json_schema", json.dumps(s)) for s in (
        {"type": "object", "properties": {"ok": {"type": "boolean"}, "n": {"type": "integer"}}},
        {"type": "object", "properties": {"k0": {"enum": ["hi", -3, True]},
                                          "k1": {"type": "string", "maxLength": 3}}},
        {"type": "array", "items": {"type": "integer"}, "maxItems": 2},
        {"type": "object", "properties": {
            "k0": {"type": "array", "items": {"type": "boolean"}, "maxItems": 2},
            "k1": {"type": "null"}}})]
    + [("regex", r'\{"key": "val", "n": [0-9]{2}\}'), ("regex", r"(abc|xyz|pqr)[0-9]{2}"),
       ("regex", r"(ab|cd)+e?"), ("regex", r'\{"n": -?[0-9]{1,3}\}')])


def check_grammar(where, req, kind_text, eos_id, n_new):
    """A constrained stream re-walked from the start state through a fresh
    compile of the pattern's character DFA (token id == byte): every token
    legal, and a stream that stopped short of ``n_new`` tokens or on eos
    (a grammar completion) ends in an accepting state."""
    from orion_tpu_torch.constrain import ConstraintSpec, compile_regex

    cdfa = compile_regex(ConstraintSpec(**{kind_text[0]: kind_text[1]}).pattern())
    toks = list(req.generated)
    eos = bool(toks) and toks[-1] == eos_id
    s = 0
    for t in toks[:-1] if eos else toks:
        s = cdfa.trans[s].get(t) if 0 <= t < 256 else None
        if s is None:
            raise AssertionError(f"{where}: request {req.rid} left its grammar "
                                 f"{kind_text}: {toks}")
    if req.outcome != "completed":
        raise AssertionError(f"{where}: request {req.rid} ended {req.outcome!r}")
    if (eos or len(toks) < n_new) and not cdfa.accepting[s]:
        raise AssertionError(f"{where}: request {req.rid} stopped outside an accepting "
                             f"state: {toks}")


def constrained_engine(params, overrides, V):
    """An engine of llama3-8b-infer + CON_OVERRIDES + ``overrides`` with
    eos V - 1, warmed up as a server is at start (a 300-token request, then
    two beside each other, one of them under a short regex when the engine
    is constrained); the warm-up's cached pages and counters are dropped,
    after the check that it contained no fault."""
    import numpy as np

    from orion_tpu_torch.config import get_config
    from orion_tpu_torch.constrain import ConstraintSpec
    from orion_tpu_torch.infer import InferenceEngine

    cfg = get_config("llama3-8b-infer", CON_OVERRIDES + overrides)
    eng = InferenceEngine(cfg, params, device="cuda", eos_id=V - 1)
    rng = np.random.default_rng(1)
    eng.generate([rng.integers(0, V, 300).tolist()], 8)
    spec = ConstraintSpec(regex="[0-9]{4}") if cfg.inference.constrained else None
    warm = [eng.submit_request(rng.integers(0, V, n).tolist(), 8, constraint=c)
            for n, c in ((300, spec), (600, None))]
    while eng.has_work():
        eng.step()
    if any(r.outcome != "completed" for r in warm):
        raise AssertionError(f"serve_constrained warm-up: {[r.outcome for r in warm]}")
    require_no_faults(eng, "serve_constrained warm-up")
    eng.clear_prefix_cache()
    eng.reset_timing()
    return eng


def constrained_wave(name, eng, prompts, specs, n_new=64):
    """Submit ``prompts`` (``specs[i]`` a (kind, text) constraint or None)
    and drain the engine, timing every mask build (host) and copy (to the
    device, synchronised) and each distinct pattern's compile (the delta of
    constrain_compile_s over its first submit). Checks every request and
    stream; returns the requests and the drive's numbers."""
    import dataclasses

    import torch

    from orion_tpu_torch import ops
    from orion_tpu_torch.constrain import ConstraintSpec

    V = eng.mcfg.vocab_size
    # Per mask kind ("verify" [B, W, V], "sample" [B, V]): build and copy
    # seconds and bytes. A copy is timed between two synchronisations, so
    # it does not count device work queued before it (a prefill's). A
    # verify mask reaches the card in its dispatch program's staging (a
    # copy into pinned memory, then to the graph's input; the step's other
    # inputs are a few hundred bytes more), a prefill's sample mask by
    # ``_device_mask``.
    masks = {kind: {"build": [], "copy": [], "bytes": []} for kind in ("verify", "sample")}
    verify_masks, sample_masks, device_mask = (eng._verify_masks, eng._sample_masks,
                                               eng._device_mask)
    stage = eng._executor._stage

    def timed_build(fn):
        def build(*a, **k):
            t = time.perf_counter()
            m = fn(*a, **k)
            if m is not None:
                rec = masks["verify" if m.ndim == 3 else "sample"]
                rec["build"].append(time.perf_counter() - t)
                rec["bytes"].append(m.nbytes)
            return m
        return build

    def timed_copy(m):
        if m is None:
            return None
        torch.cuda.synchronize()
        t = time.perf_counter()
        d = device_mask(m)
        torch.cuda.synchronize()
        masks["verify" if m.ndim == 3 else "sample"]["copy"].append(time.perf_counter() - t)
        return d

    def timed_stage(prog, tensors):
        if tensors.get("legal_mask") is None:
            return stage(prog, tensors)
        torch.cuda.synchronize()
        t = time.perf_counter()
        stage(prog, tensors)
        torch.cuda.synchronize()
        masks["verify"]["copy"].append(time.perf_counter() - t)

    eng._verify_masks, eng._sample_masks = timed_build(verify_masks), timed_build(sample_masks)
    eng._device_mask = timed_copy
    eng._executor._stage = timed_stage
    tm0 = dict(eng.timing)
    cs0 = dataclasses.asdict(eng.constraint_stats)
    compile_s = {}
    ops.reset_launches()
    t0 = time.perf_counter()
    reqs = []
    for p, s in zip(prompts, specs):
        c0 = eng.constraint_stats.compile_s
        reqs.append(eng.submit_request(
            p, n_new, constraint=None if s is None else ConstraintSpec(**{s[0]: s[1]})))
        if s is not None and s[1] not in compile_s:
            compile_s[s[1]] = {"kind": s[0], "compile_s": eng.constraint_stats.compile_s - c0,
                               "dfa_states": reqs[-1].constraint.dfa.n_states}
    while eng.has_work():
        eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches()
    del eng._verify_masks, eng._sample_masks, eng._device_mask, eng._executor._stage
    require_no_faults(eng, f"serve_constrained {name}")
    eng.assert_page_accounting()
    tm = {k: eng.timing[k] - tm0[k] for k in tm0}
    cs = {k: v - cs0[k] for k, v in dataclasses.asdict(eng.constraint_stats).items()}
    for r, s in zip(reqs, specs):
        if s is not None:
            check_grammar(f"serve_constrained {name}", r, s, V - 1, n_new)
        elif r.outcome != "completed" or not (
                len(r.generated) == n_new or r.generated[-1] == V - 1):
            raise AssertionError(f"serve_constrained {name}: request {r.rid} ended "
                                 f"{r.outcome!r} with {len(r.generated)} tokens")
    decode_tokens = sum(len(r.generated) - 1 for r in reqs)
    busy = tm["decode_s"] + tm["mixed_s"]
    verify_steps = tm["verify_steps"]
    return reqs, {
        "requests": len(reqs), "constrained": sum(s is not None for s in specs),
        "prompt_tokens": sum(map(len, prompts)), "new_tokens_max": n_new, "wall_s": wall,
        "decode_tokens": decode_tokens, "decode_tok_s": decode_tokens / busy,
        "prefill_s": tm["prefill_s"], "mixed_s": tm["mixed_s"], "decode_s": tm["decode_s"],
        "verify_s": tm["verify_s"], "steps": tm["steps"], "verify_steps": verify_steps,
        "verify_step_wall_ms": 1e3 * tm["verify_s"] / verify_steps if verify_steps else None,
        "constrain": cs, "compile_s_by_pattern": compile_s,
        "masks": {kind: {
            "count": len(rec["build"]),
            "build_ms_median": 1e3 * statistics.median(rec["build"]) if rec["build"] else None,
            "copy_ms_median": 1e3 * statistics.median(rec["copy"]) if rec["copy"] else None,
            "build_ms_max": 1e3 * max(rec["build"]) if rec["build"] else None,
            "copy_ms_max": 1e3 * max(rec["copy"]) if rec["copy"] else None,
            "bytes_max": max(rec["bytes"]) if rec["bytes"] else None,
            "build_s_total": sum(rec["build"]), "copy_s_total": sum(rec["copy"]),
        } for kind, rec in masks.items()},
        "outcomes_generated": [len(r.generated) for r in reqs],
        "launches": launches,
    }


def phase_serve_constrained(params=None):
    """llama3-8b-infer at full width and depth with grammar-constrained
    decoding: drives A0 and C0 (constrained=false), C0 and C1
    (constrained=true), C2 (int8 pools, chunked prefill, tree speculation),
    on the serve phase's ``params`` when given, else on fresh seeded
    weights. Returns the launches of every drive together."""
    import numpy as np
    import torch

    from orion_tpu_torch.config import get_config
    from orion_tpu_torch.models import init_params

    cfg = get_config("llama3-8b-infer")
    V = cfg.model.vocab_size
    if params is None:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        params = init_params(cfg.model, gen, device="cuda", dtype="bfloat16")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, V, n).tolist() for n in rng.integers(100, 1001, 16)]
    c0_prompts = [rng.integers(0, V, n).tolist() for n in rng.integers(100, 1001, 8)]
    specs = [CON_SPECS[i // 2] if i % 2 == 0 else None for i in range(16)]
    totals, res, c0 = {}, {}, {}

    def add(launches):
        for k, n in launches.items():
            totals[k] = totals.get(k, 0) + n

    for name, overrides, drives in (
            ("off", [], (("C0", c0_prompts, [None] * 8), ("A0", prompts, [None] * 16))),
            ("on", ["inference.constrained=true"],
             (("C0", c0_prompts, [None] * 8), ("C1", prompts, specs))),
            ("C2", ["inference.constrained=true"] + CON_C2, (("C2", prompts, specs),))):
        eng = constrained_engine(params, overrides, V)
        for drive, ps, sp in drives:
            reqs, r = constrained_wave(drive, eng, ps, sp)
            add(r["launches"])
            if drive == "C0":
                c0[name] = [list(q.generated) for q in reqs]
            else:
                res[drive] = r
            emit({"phase": "serve_constrained", "drive": drive, "engine": name,
                  "overrides": CON_OVERRIDES + overrides, "eos_id": V - 1,
                  "nvidia_smi": smi_line(), **r})
        del eng
        free_engine()
    if c0["on"] != c0["off"]:
        raise AssertionError("serve_constrained C0: constrained=true streams differ from "
                             "constrained=false")
    missing = [k for drive, k in (("C1", "ragged_verify"), ("C2", "ragged_verify_int8"))
               if res[drive]["launches"][k] <= 0]
    if missing:
        raise AssertionError(f"serve_constrained: kernels never launched: {missing}")
    for drive in ("C1", "C2"):
        cs = res[drive]["constrain"]
        if cs["requests"] != 8 or cs["masked_steps"] < 1 or cs["dead_ends"]:
            raise AssertionError(f"serve_constrained {drive}: counters {cs}")
    emit({"phase": "serve_constrained", "c0_byte_identical": True,
          "decode_tok_s": {d: res[d]["decode_tok_s"] for d in ("A0", "C1", "C2")},
          "wall_s": {d: res[d]["wall_s"] for d in ("A0", "C1", "C2")},
          "launches": totals, "nvidia_smi": smi_line()})
    return totals


# serve_graphs: llama3-8b-infer at full width and depth (the serve's weights),
# the engine's dispatch programs as CUDA graphs held against the same
# dispatches run eagerly. (a) one decode window (W 8), one chain verify and
# one tree verify (W 5) of the serve's 16 requests after their prefill,
# eager and captured on the same inputs and pool: tokens and verdicts
# equal, the written pool rows byte for byte, every step's logits within
# TOL["graph_logits"]. (b) the serve's 16 requests (SG_NEW new tokens)
# with cuda_graphs=False and then captured, each after the serve's
# one-request warm-up: decode tokens/s, TTFT, the host share of a decode
# step (1 - the window's device time alone, by graph replay, over the
# step's wall), capture seconds, graph pool bytes, launches (equal both
# ways), and the eager prefill's enqueue beside its device time. (c) the
# captured serve with inference.decode_window_autotune: the window's path.
SG_NEW = 64
# A tree of 5 columns: two children of the root, one grandchild under each.
SG_TREE = dict(depths=[0, 1, 1, 2, 2], parents=[0, 0, 0, 1, 2],
               words=[0b1, 0b11, 0b101, 0b1011, 0b10101])


def sg_prompts(V):
    """The serve phase's 16 prompts (100-2000 tokens, numpy seed 0)."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(0, V, size=n).tolist()
            for n in np.linspace(100, 2000, 16).astype(int)]


def sg_rows(eng, width):
    """Pool rows (every layer) of the pages a dispatch of ``width``
    positions past each live slot's cursor writes. Not scratch page 0,
    which idle slots write at once, in no order (the kernels' contract)."""
    import numpy as np
    import torch

    pages = set()
    for r in eng.slots:
        if r is not None and not r.done:
            s = r.slot
            for pos in range(int(eng.seq_lens[s]), int(eng.seq_lens[s]) + width):
                pages.add(int(eng.page_table[s, min(pos, eng.icfg.max_seq_len - 1) // eng.psz]))
    NP = eng.icfg.num_pages
    rows = np.array([layer * NP + p for layer in range(eng.mcfg.n_layers) for p in sorted(pages)])
    return torch.from_numpy(rows).to(eng.device)


def sg_compare(name, eng, executors, path, fn, inputs, static, width, stash, real,
               restore=True):
    """Run one dispatch program through each of ``executors`` (eager, then
    captured) on the same inputs, the written pool rows restored between
    them unless ``restore`` is False: outputs, pool bytes and each step's
    logits compared where ``real`` holds: the live slots [B] (decode) or
    their real verify positions [B, W]. Idle slots read scratch page 0,
    and a row's padding columns are not tokens."""
    import torch

    rows = sg_rows(eng, width)
    before = [t[rows].clone() for t in eng.cache.values()]
    outs, pools, logits = [], [], []
    for ex in executors:
        if restore or not outs:
            for t, b in zip(eng.cache.values(), before):
                t[rows] = b
        stash.clear()
        out = ex.launch(path, fn, inputs, static)
        outs.append(out.cpu())
        # Eager: one block a step. Captured: the warm-up's blocks, then the
        # capture's, whose memory the replay wrote.
        n = len(logits[0]) if logits else len(stash)
        logits.append([t.clone() for t in stash[-n:] if not ex.graphs] or
                      [t.clone() for t in stash[n:2 * n]])
        pools.append([t[rows].clone() for t in eng.cache.values()])
    torch.cuda.synchronize()
    if len(logits[0]) != len(logits[1]) or not logits[0]:
        raise AssertionError(f"serve_graphs {name}: {len(logits[0])} eager, "
                             f"{len(logits[1])} captured logit blocks")
    sel = torch.from_numpy(real)
    diff = outs[0] != outs[1]                  # verify: [2, B, W]; decode: [W, B]
    real_diff = diff[:, sel]
    pick = lambda t: t[sel.to(t.device)]   # noqa: E731  (logits [B, V] or [B, W, V])
    errs = [max_err(pick(a), pick(b)) for a, b in zip(logits[0], logits[1])]
    row = {"outputs_equal": not bool(real_diff.any()), "outputs_differing": int(real_diff.sum()),
           "outputs_differing_elsewhere": int(diff.sum()) - int(real_diff.sum()),
           "pool_bytes_equal": all(torch.equal(bits(a), bits(b))
                                   for a, b in zip(pools[0], pools[1])),
           "pool_rows": int(rows.numel()), "logit_blocks": len(logits[0]),
           "max_abs_err": max(errs),
           "logits_bitwise": all(torch.equal(bits(pick(a)), bits(pick(b)))
                                 for a, b in zip(logits[0], logits[1]))}
    atol, rtol = TOL["graph_logits"]["bfloat16"]
    row["logits_within_tol"] = all(
        torch.allclose(pick(b).float(), pick(a).float(), atol=atol, rtol=rtol)
        and bool(torch.isfinite(pick(b)).all()) for a, b in zip(logits[0], logits[1]))
    return row


def sg_window(cfg, params, prompts):
    """serve_graphs (a): the decode window and the chain and tree verify
    programs of the serve's batch after its prefill, eager against
    captured (fresh executors of one engine, the sampler and the verifiers
    wrapped to keep each step's logits)."""
    import numpy as np

    import orion_tpu_torch.infer.runner as runner_mod
    import orion_tpu_torch.infer.sampling as sampling_mod
    from orion_tpu_torch.infer import InferenceEngine
    from orion_tpu_torch.infer.executor import DispatchExecutor

    eng = InferenceEngine(cfg, params, device="cuda")
    for p in prompts:
        eng.submit(p, SG_NEW)
    eng.step()   # admission, the burst's prefill, the first window
    live = [r for r in eng.slots if r is not None and not r.done]
    W, Wv, B = eng.decode_window, eng.icfg.speculate_tokens + 1, eng.max_batch
    eng._grow_pages(max(W, Wv))
    rng = np.random.default_rng(1)
    vtok = np.zeros((B, Wv), np.int32)
    vtok[:, 0] = eng.last_token
    vtok[:, 1:] = rng.integers(0, eng.mcfg.vocab_size, (B, Wv - 1))
    lens = np.full(B, Wv, np.int32)
    lens[::3] = rng.integers(1, Wv, len(lens[::3]))
    base = dict(seq_lens=eng.seq_lens.copy(), page_table=eng.page_table.copy())
    greedy = dict(temperature=0.0, top_k=0, top_p=1.0, nan_guard=False)
    tree = {k: np.tile(np.asarray(v, np.int32), (B, 1)) for k, v in SG_TREE.items()}
    slots = eng._live_mask(live)
    real = slots[:, None] & (np.arange(Wv)[None, :] < lens[:, None])
    cases = {
        "decode_window": ("decode", eng._decode_program,
                          dict(tokens=eng.last_token.copy(), active=slots, **base),
                          dict(n_steps=W, **greedy), W, slots),
        "verify_chain": ("verify", eng._verify_program,
                         dict(tokens=vtok, lens=lens, **base), greedy, Wv, real),
        "verify_tree": ("verify", eng._verify_program,
                        dict(tokens=vtok, lens=np.full(B, Wv, np.int32), depths=tree["depths"],
                             parents=tree["parents"], tree_mask=tree["words"], **base),
                        greedy, Wv, np.repeat(slots[:, None], Wv, 1)),
    }
    stash = []
    real_sample, real_verify = sampling_mod.sample, runner_mod._verify_sample

    def sample_probe(logits, *a, **k):
        stash.append(logits)
        return real_sample(logits, *a, **k)

    def verify_probe(logits, *a, **k):
        stash.append(logits)
        return real_verify(logits, *a, **k)

    sampling_mod.sample, runner_mod._verify_sample = sample_probe, verify_probe
    try:
        out = {}
        for name, (path, fn, inputs, static, width, real) in cases.items():
            executors = (DispatchExecutor(eng, graphs=False), DispatchExecutor(eng, graphs=True))
            out[name] = sg_compare(name, eng, executors, path, fn, inputs, static, width, stash,
                                   real)
            out[name]["capture_s"] = executors[1].capture_s
        # The control: the chain verify eager twice, the second over the
        # first's pool writes (what a replay finds after its warm-up).
        path, fn, inputs, static, width, real = cases["verify_chain"]
        out["control_chain_eager_twice"] = sg_compare(
            "control", eng, (DispatchExecutor(eng, graphs=False),) * 2, path, fn, inputs,
            static, width, stash, real, restore=False)
    finally:
        sampling_mod.sample, runner_mod._verify_sample = real_sample, real_verify
    stash.clear()
    _, _, inputs, static, _, _ = cases["decode_window"]
    out["failed_capture"] = sg_failed_capture(eng, inputs, static)
    while eng.has_work():
        eng.step()
    require_no_faults(eng, "serve_graphs (a)")
    return out


def sg_failed_capture(eng, inputs, static):
    """A capture that fails (a host sync inside the step, which a capture
    refuses) raises a DispatchFault inside the envelope, counted, with no
    program kept and no eager result; the next capture works."""
    from orion_tpu_torch.runtime.fault import DispatchFault

    ex = eng._executor

    def synced(**kw):
        out = eng._decode_program(**kw)
        out.sum().item()   # a host sync: fine in the warm-up, refused in the capture
        return out

    n0, f0 = len(ex._programs), eng.robust.dispatch_faults
    try:
        ex.run("decode", ex.launch, "decode", synced, inputs, dict(static, n_steps=4))
        raised = None
    except DispatchFault as e:
        raised = str(e)[:300]
    row = {"raised": raised, "dispatch_faults": eng.robust.dispatch_faults - f0,
           "programs_kept": len(ex._programs) - n0}
    ex.run("decode", ex.launch, "decode", eng._decode_program, inputs, dict(static, n_steps=2))
    row["next_capture_ok"] = len(ex._programs) - n0 == 1
    if not (raised and row["dispatch_faults"] == 1 and row["next_capture_ok"]):
        raise AssertionError(f"serve_graphs (a): a failed capture was not contained: {row}")
    eng.robust.dispatch_faults = f0   # counted above; the serve goes on fault-free
    return row


def sg_window_device_ms(ex, reps=10):
    """The device time of one decode window alone: the serve's last decode
    graph replayed back to back between CUDA events."""
    import torch

    prog = next(p for k, p in ex._programs.items() if k[0] == "decode")
    prog.graph.replay()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        prog.graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def sg_serve(cfg, params, prompts, graphs, autotune=False):
    """serve_graphs (b) and (c): the serve's warm-up, then its 16 requests,
    each step timed; with ``graphs`` the eager prefill's enqueue and
    device time are taken too (a synchronisation after its call)."""
    import numpy as np
    import torch

    import orion_tpu_torch.infer.engine as engine_mod
    from orion_tpu_torch import ops
    from orion_tpu_torch.infer import InferenceEngine

    eng = InferenceEngine(cfg, params, device="cuda", cuda_graphs=graphs)
    ex = eng._executor
    V = cfg.model.vocab_size
    eng.generate([np.random.default_rng(7).integers(0, V, size=100).tolist()], 2)
    warm = {"captures": ex.captures, "capture_s": ex.capture_s, "pool_bytes": ex.pool_bytes}
    eng.reset_timing()
    prefill = []
    real_prefill = engine_mod.prefill_step

    def timed_prefill(*a, **k):
        t = time.perf_counter()
        out = real_prefill(*a, **k)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        prefill.append((t1 - t, time.perf_counter() - t))
        return out

    engine_mod.prefill_step = timed_prefill
    ops.reset_launches()
    replays0 = ex.replays
    steps = []
    try:
        t0 = time.perf_counter()
        reqs = [eng.submit_request(p, SG_NEW) for p in prompts]
        while eng.has_work():
            w0, p0, n0 = eng.timing["windows"], eng.timing["prefill_s"], eng.decode_window
            ts = time.perf_counter()
            eng.step()
            steps.append((time.perf_counter() - ts, eng.timing["windows"] > w0
                          and eng.timing["prefill_s"] == p0, n0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        engine_mod.prefill_step = real_prefill
    launches = ops.launches()
    require_no_faults(eng, f"serve_graphs {'captured' if graphs else 'eager'}")
    for r in reqs:
        if not (r.outcome == "completed" and len(r.generated) == SG_NEW):
            raise AssertionError(f"serve_graphs: request {r.rid} {r.outcome!r}, "
                                 f"{len(r.generated)} tokens")
    tm = eng.reset_timing()
    decode_walls = [w for w, dec, _ in steps if dec]
    ttft = sorted(r.t_first - r.t_submit for r in reqs)
    decode_tokens = sum(len(r.generated) - 1 for r in reqs)
    row = {"graphs": graphs, "wall_s": wall, "steps": len(steps),
           "decode_tok_s": decode_tokens / tm["decode_s"],
           "ttft_s_median": statistics.median(ttft), "ttft_s_max": ttft[-1],
           "decode_step_wall_ms_median": 1e3 * statistics.median(decode_walls),
           "decode_steps": len(decode_walls),
           "split_s": {k: tm[k] for k in ("device_s", "decode_device_s", "mixed_device_s",
                                          "prefill_s", "host_s")},
           "prefill_dispatches": len(prefill),
           "prefill_enqueue_s": sum(e for e, _ in prefill),
           "prefill_done_s": sum(d for _, d in prefill),
           "launches": launches, "launches_per_step": {
               k: v / len(steps) for k, v in launches.items() if v},
           "warmup": warm, "window_path": [n for _, _, n in steps] + [eng.decode_window]}
    if graphs:
        row.update(captures=ex.captures, capture_s=ex.capture_s, pool_bytes=ex.pool_bytes,
                   serve_replays=ex.replays - replays0)
        if not autotune and row["serve_replays"] != tm["windows"]:
            raise AssertionError(f"serve_graphs: {row['serve_replays']} replays for "
                                 f"{tm['windows']} decode windows")
        row["window_device_ms"] = sg_window_device_ms(ex)
    return row, eng


def phase_serve_graphs(params=None):
    """serve_graphs (a)-(c) on the serve phase's ``params`` when given,
    else on fresh seeded weights; returns the captured serve's launches."""
    import torch

    from orion_tpu_torch.config import get_config
    from orion_tpu_torch.models import init_params

    cfg = get_config("llama3-8b-infer")
    if params is None:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        params = init_params(cfg.model, gen, device="cuda", dtype="bfloat16")
    prompts = sg_prompts(cfg.model.vocab_size)
    smi = smi_line()
    window = sg_window(cfg, params, prompts)
    free_engine()
    emit({"phase": "serve_graphs", "part": "a", "preset": "llama3-8b-infer",
          "nvidia_smi": smi, **window})
    bad = {name: row for name, row in window.items() if name != "failed_capture"
           and not (row["outputs_equal"] and row["pool_bytes_equal"] and row["logits_within_tol"])}
    if bad:
        raise AssertionError(f"serve_graphs (a): captured differs from eager: {bad}")
    rows = {}
    for graphs in (False, True):
        rows[graphs], eng = sg_serve(cfg, params, prompts, graphs)
        del eng
        free_engine()
    eager, captured = rows[False], rows[True]
    if eager["launches"] != captured["launches"] or eager["steps"] != captured["steps"]:
        raise AssertionError(f"serve_graphs: launches differ: eager {eager['launches']} "
                             f"in {eager['steps']} steps, captured {captured['launches']} "
                             f"in {captured['steps']}")
    dev_ms = captured["window_device_ms"]
    for r in (eager, captured):
        r["decode_host_share"] = 1.0 - dev_ms / r["decode_step_wall_ms_median"]
    emit({"phase": "serve_graphs", "part": "b", "preset": "llama3-8b-infer",
          "requests": len(prompts), "new_tokens_each": SG_NEW, "nvidia_smi": smi,
          "window_device_ms": dev_ms, "eager": eager, "captured": captured,
          "decode_speedup": captured["decode_tok_s"] / eager["decode_tok_s"]})
    at_cfg = get_config("llama3-8b-infer", ["inference.decode_window_autotune=true"])
    auto, eng = sg_serve(at_cfg, params, prompts, True, autotune=True)
    del eng
    free_engine()
    emit({"phase": "serve_graphs", "part": "c", "preset": "llama3-8b-infer",
          "nvidia_smi": smi, "decode_window_max": at_cfg.inference.decode_window_max,
          "host_share_target": at_cfg.inference.decode_host_share_target,
          "final_window": auto["window_path"][-1], **auto})
    return captured["launches"]

# -- the host KV tier, long context and the gather prefill body -------------

# serve_host_tier: llama3-8b-infer (bf16, full width and depth) with the
# prefix cache over a 320-page pool (2.7 GB) and a host tier: a wave of 8
# distinct 2048-token prompts (256 pages) is demoted by a second such wave,
# and a third wave (the first's prompts + 100-token tails) restores them.
HT_PROMPTS, HT_LEN, HT_TAIL, HT_NEW, HT_POOL = 8, 2048, 100, 16, 320
HT_MAX_BYTES = 4 << 30
# serve_long: Mistral-7B (mistral-7b-fsdp at parallel.fsdp=1: window 4096
# on all 32 layers, vocab 32000, bf16) serving two 8064-token prompts at
# once over a 96-page pool (one such request spans 127 pages), chunked by
# 512, a residency cap of 32 pages; its reference serves the same with
# long_context off over 300 pages.
LONG_LEN, LONG_NEW, LONG_POOL, LONG_CAP = 8064, 64, 96, 32
LONG_OVERRIDES = ["parallel.fsdp=1", "inference.long_context=true",
                  "inference.chunked_prefill=true", "inference.prefill_chunk_tokens=512",
                  "inference.prefill_chunk=512", "inference.max_batch_size=2",
                  "inference.max_seq_len=8192", f"inference.num_pages={LONG_POOL}",
                  f"inference.request_resident_pages={LONG_CAP}"]
LONG_REF_OVERRIDES = ["parallel.fsdp=1", "inference.chunked_prefill=true",
                      "inference.prefill_chunk_tokens=512", "inference.prefill_chunk=512",
                      "inference.max_batch_size=2", "inference.max_seq_len=8192",
                      "inference.num_pages=300"]
# serve_gather: paged_prefill=false, prefix-cache hits through the gather
# body (K3 with positions), against paged_prefill=true (K9). The first
# token's logits of each warm row: two different bf16 kernels over 32
# layers, held per row to a relative RMS of 2^-4 (K4_SLOT_REL's bound).
GATHER_OVERRIDES = ["inference.prefix_cache=true", "inference.max_batch_size=8"]
GATHER_LOGIT_REL = 2.0 ** -4
GATHER_KERNELS = ("flash_fwd", "flash_fwd_pos", "flash_fwd_pos_merge", "paged_prefill")


def mem_available() -> int:
    """The machine's MemAvailable (/proc/meminfo), in bytes."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def host_tier_budget():
    """(host_tier_bytes, MemAvailable): a quarter of the free RAM, at most
    4 GiB (512 pages of llama3-8b-infer or Mistral-7B)."""
    avail = mem_available()
    return min(HT_MAX_BYTES, avail // 4), avail


def pinned_rates(nbytes):
    """Device-to-host and host-to-device GB/s over pinned memory: one copy
    of ``nbytes``, CUDA events, the median of 5 after a warm-up."""
    import torch

    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    out = {}
    for name, dst, src in (("d2h", host, dev), ("h2d", dev, host)):
        dst.copy_(src, non_blocking=True)
        times = []
        for _ in range(5):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            dst.copy_(src, non_blocking=True)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 1e3)
        out[name] = nbytes / statistics.median(times) / 1e9
    del dev, host
    return out


def prefix_snapshot(eng, prompts, n_pages):
    """Device copies of the cached prefix pages of each prompt (every cache
    tensor, all layers), through ``gather_pages``."""
    import torch

    from orion_tpu_torch.infer.kv_cache import gather_pages

    snaps = []
    for p in prompts:
        pages, node = eng._pcache.match(p + [0], n_pages)
        if node is None or len(pages) != n_pages or not all(isinstance(x, int) for x in pages):
            raise AssertionError(f"prefix of {n_pages} device pages not cached: {pages}")
        snaps.append({k: v.clone() for k, v in gather_pages(
            eng.cache, torch.tensor(pages), n_layers=eng.mcfg.n_layers,
            num_pages=eng.icfg.num_pages).items()})
        eng._pcache.unlock(node)
    return snaps


def phase_serve_host_tier(params=None):
    """The host tier at llama3-8b-infer: three waves over an undersized
    pool (demote, then restore), the restored pages bit for bit the
    demoted ones, the third wave's streams those of a pool that evicts
    nothing, the copy rates over pinned memory, the restore overhead, the
    break-even it gives, offload_prefix_cache, and a restore fault."""
    import numpy as np
    import torch

    from orion_tpu_torch import ops
    from orion_tpu_torch.config import get_config
    from orion_tpu_torch.infer import InferenceEngine
    from orion_tpu_torch.infer.kv_cache import host_tier_break_even_tokens
    from orion_tpu_torch.models import init_params
    from orion_tpu_torch.runtime.fault import FaultInjector, FaultSpec

    hbytes, avail = host_tier_budget()
    ov = ["inference.prefix_cache=true", f"inference.host_tier_bytes={hbytes}",
          f"inference.num_pages={HT_POOL}", f"inference.max_batch_size={HT_PROMPTS}"]
    cfg = get_config("llama3-8b-infer", ov)
    V, psz = cfg.model.vocab_size, cfg.inference.page_size
    if params is None:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        params = init_params(cfg.model, gen, device="cuda", dtype="bfloat16")
    rng = np.random.default_rng(7)
    wave1 = [rng.integers(0, V, HT_LEN).tolist() for _ in range(HT_PROMPTS)]
    wave2 = [rng.integers(0, V, HT_LEN).tolist() for _ in range(HT_PROMPTS)]
    wave3 = [p + rng.integers(0, V, HT_TAIL).tolist() for p in wave1]
    warm = rng.integers(0, V, 300).tolist()
    n_pre = HT_LEN // psz
    inj = FaultInjector([])
    eng = InferenceEngine(cfg, params, device="cuda", fault_injector=inj)
    hp = eng._host_pool
    eng.generate([warm], 2)
    eng.clear_prefix_cache()
    eng.reset_timing()
    totals = {}

    def wave(i, prompts):
        reqs, res = serve_wave(eng, prompts, HT_NEW)
        for k, n in res["launches"].items():
            totals[k] = totals.get(k, 0) + n
        emit({"phase": "serve_host_tier", "wave": i, **res})
        return reqs, res

    r1, w1 = wave(1, wave1)
    t1 = eng.reset_timing()
    before = prefix_snapshot(eng, wave1, n_pre)
    r2, _ = wave(2, wave2)
    t2 = eng.reset_timing()
    # Wave 2's allocations demote the coldest of wave 1's pages (all but
    # what the free pages absorbed); wave 3's restores demote the rest,
    # colder than wave 2's, so every prefix comes back from the host.
    demoted = t2["evicted_to_host"]
    if demoted < HT_PROMPTS * n_pre // 2 or eng._pcache.host_pages != demoted:
        raise AssertionError(f"serve_host_tier: wave 2 demoted {demoted} pages, "
                             f"{eng._pcache.host_pages} host-resident")
    r3, _ = wave(3, wave3)
    t3 = eng.reset_timing()
    if t3["host_hits"] != HT_PROMPTS or t3["host_restored_pages"] != HT_PROMPTS * n_pre:
        raise AssertionError(f"serve_host_tier: wave 3 restored {t3['host_restored_pages']} "
                             f"pages in {t3['host_hits']} hits")
    after = prefix_snapshot(eng, wave1, n_pre)
    restored_equal = all(torch.equal(bits(a[k]), bits(b[k]))
                         for a, b in zip(before, after) for k in a)
    if not restored_equal:
        raise AssertionError("serve_host_tier: restored pages differ from the demoted ones")
    restored_bytes = sum(t.numel() * t.element_size() for s_ in after for t in s_.values())
    del before, after
    # offload_prefix_cache: every idle cached page to the host, then the
    # copies' end through their events (spill_s is the enqueue).
    t0 = time.perf_counter()
    n_off = eng.offload_prefix_cache()
    for ev in {id(e): e for e in hp._pending.values()}.values():
        ev.synchronize()
    offload_wall = time.perf_counter() - t0
    t_off = eng.reset_timing()
    # A restore fault: the next admission's restore raises in its envelope.
    free0, marks0, slots0 = eng.alloc.free_pages, eng._pcache.host_pages, hp.free_slots
    inj.specs.append(FaultSpec("restore", step=eng.step_no))
    fr = eng.submit_request(wave3[0], HT_NEW)
    eng.step()
    unwound = dict(failed_steps=eng.robust.failed_steps,
                   dispatch_faults=eng.robust.dispatch_faults,
                   pool_free_equal=eng.alloc.free_pages == free0,
                   host_markers_equal=eng._pcache.host_pages == marks0,
                   host_slots_equal=hp.free_slots == slots0)
    eng.assert_page_accounting()
    while eng.has_work():
        eng.step()
    if not (unwound["failed_steps"] == 1 and unwound["dispatch_faults"] == 1
            and unwound["pool_free_equal"] and unwound["host_markers_equal"]
            and unwound["host_slots_equal"] and fr.outcome == "completed"):
        raise AssertionError(f"serve_host_tier: restore fault not contained: {unwound}, "
                             f"{fr.outcome}")
    t_fault = eng.reset_timing()
    eng.assert_page_accounting()
    streams = [[r.generated for r in rs] for rs in (r1, r3)]
    pb = hp.page_bytes
    del eng, hp
    free_engine()

    # The reference: a pool that evicts nothing (2048 pages), waves 1 and 3.
    ref = InferenceEngine(get_config("llama3-8b-infer", ["inference.prefix_cache=true",
                                                         f"inference.max_batch_size={HT_PROMPTS}"]),
                          params, device="cuda")
    ref.generate([warm], 2)
    ref.clear_prefix_cache()
    ref_streams = [[r.generated for r in serve_wave(ref, w, HT_NEW)[0]] for w in (wave1, wave3)]
    del ref
    free_engine()
    if ref_streams != streams:
        raise AssertionError("serve_host_tier: streams differ from the non-evicting pool's")

    rates = pinned_rates(n_pre * pb)
    # Wave 3's restores wait behind the spill of the pages their fresh
    # pages displaced (one stream); the fault's retry restores into free
    # pages: the restore alone, and its overhead past the bytes' time.
    per_call = t3["restore_s"] / t3["host_hits"]
    clean = t_fault["restore_s"] / t_fault["host_hits"]
    clean_pages = t_fault["host_restored_pages"] / t_fault["host_hits"]
    overhead = max(clean - clean_pages * pb / (rates["h2d"] * 1e9), 0.0)
    prefill_tok_s = t1["prefill_tokens"] / t1["prefill_s"]
    icfg = cfg.inference
    emit({"phase": "serve_host_tier", "preset": "llama3-8b-infer", "overrides": ov,
          "host_tier_bytes": hbytes, "mem_available_bytes": avail, "host_slots": hbytes // pb,
          "page_bytes": pb, "pool_pages": HT_POOL,
          "demoted_pages_wave2": demoted, "demoted_pages_wave3": t3["evicted_to_host"],
          "restored_pages": t3["host_restored_pages"], "host_hits": t3["host_hits"],
          "restored_bytes": restored_bytes, "restored_bytes_equal": restored_equal,
          "wave3_streams_equal_non_evicting": True,
          "d2h_gbps_pinned": rates["d2h"], "h2d_gbps_pinned": rates["h2d"],
          "copy_bytes": n_pre * pb,
          "restore_s_per_call_wave3": per_call, "restore_s_clean": clean,
          "restore_clean_pages": clean_pages,
          "restore_overhead_s": overhead,
          "spill_s_waves": t2["spill_s"] + t3["spill_s"],
          "prefill_tok_s_measured": prefill_tok_s,
          "break_even_tokens_measured": host_tier_break_even_tokens(
              pb, psz, rates["h2d"], overhead, prefill_tok_s),
          "break_even_tokens_defaults": host_tier_break_even_tokens(
              pb, psz, icfg.host_tier_h2d_gbps, icfg.host_tier_restore_overhead_s,
              icfg.host_tier_prefill_tok_s),
          "offload_pages": n_off, "offload_spill_s": t_off["spill_s"],
          "offload_wall_s": offload_wall, "restore_fault": unwound,
          "restore_fault_counters": {k: t_fault[k] for k in ("dispatch_faults", "failed_steps",
                                                             "host_hits",
                                                             "host_restored_pages")},
          "smi": smi_line()})
    missing = [k for k in ("rmsnorm_fwd", "rope_fwd", "flash_fwd", "paged_decode",
                           "paged_prefill") if totals[k] <= 0]
    if missing:
        raise AssertionError(f"serve_host_tier: kernels never launched: {missing}")
    return totals


def phase_serve_gather(params=None):
    """paged_prefill=false at llama3-8b-infer: a second wave's prefix hits
    run the gather body (K3 with positions, no K9); each warm row's first
    logits against the paged_prefill=true engine's (GATHER_LOGIT_REL).
    Then tiny-llama in float32: both settings' streams equal."""
    import numpy as np
    import torch

    from orion_tpu_torch import ops
    from orion_tpu_torch.config import get_config
    from orion_tpu_torch.infer import InferenceEngine
    from orion_tpu_torch.models import init_params

    rng = np.random.default_rng(11)
    V = get_config("llama3-8b-infer").model.vocab_size
    sys_p = rng.integers(0, V, 1024).tolist()
    wave1 = [sys_p + rng.integers(0, V, n).tolist() for n in (100, 300, 500, 700)]
    wave2 = [sys_p + rng.integers(0, V, n).tolist() for n in (150, 350, 450, 640)]
    if params is None:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        params = init_params(get_config("llama3-8b-infer").model, gen, device="cuda",
                             dtype="bfloat16")
    out = {}
    for paged in (False, True):
        cfg = get_config("llama3-8b-infer",
                         GATHER_OVERRIDES + [f"inference.paged_prefill={str(paged).lower()}"])
        eng = InferenceEngine(cfg, params, device="cuda")
        logits = []
        sample = eng._sample

        def keep(lg, reqs, sample=sample, logits=logits):
            logits.append(lg[: len(reqs)].float().clone())
            return sample(lg, reqs)

        eng._sample = keep
        _, w1 = serve_wave(eng, wave1, 8)
        logits.clear()
        reqs, w2 = serve_wave(eng, wave2, 8)
        if eng.prefix_stats.hits < len(wave2):
            raise AssertionError(f"serve_gather: {eng.prefix_stats.hits} prefix hits")
        require_no_faults(eng, "serve_gather")
        out[paged] = dict(logits=torch.cat(logits), launches=w2["launches"],
                          prefill_tok_s=w2["prefill_tok_s"], ttft=w2["ttft_s_median"])
        emit({"phase": "serve_gather", "paged_prefill": paged, "wave": 2, **w2})
        del eng
        free_engine()
    g, p = out[False], out[True]
    if (g["launches"]["flash_fwd_pos"] <= 0 or g["launches"]["flash_fwd_pos_merge"] <= 0
            or g["launches"]["paged_prefill"] != 0):
        raise AssertionError(f"serve_gather: gather body launches {g['launches']}")
    d = (g["logits"] - p["logits"]).pow(2).mean(-1).sqrt()
    rel = (d / p["logits"].pow(2).mean(-1).sqrt()).tolist()
    if max(rel) > GATHER_LOGIT_REL:
        raise AssertionError(f"serve_gather: first-token logits rel RMS {rel}")

    # tiny-llama, float32, on the card: paged_prefill false and true.
    small = ["inference.max_seq_len=128", "inference.page_size=16", "inference.num_pages=32",
             "inference.max_batch_size=4", "inference.prefill_chunk=16",
             "inference.prefix_cache=true", "inference.chunked_prefill=true",
             "inference.prefill_chunk_tokens=32"]
    tcfg = get_config("tiny-llama", small)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    tparams = init_params(tcfg.model, gen, device="cuda")
    sys_t = rng.integers(1, 256, 32).tolist()
    waves = [[sys_t + rng.integers(1, 256, n).tolist() for n in (5, 20, 37)],
             [sys_t + rng.integers(1, 256, n).tolist() for n in (3, 18)]]
    tiny = {}
    for paged in (False, True):
        eng = InferenceEngine(get_config("tiny-llama", small + [
            f"inference.paged_prefill={str(paged).lower()}"]), tparams, device="cuda")
        ops.reset_launches()
        tiny[paged] = [eng.generate(w, 8) for w in waves]
        tiny[f"launches_{paged}"] = ops.launches()
    if tiny[False] != tiny[True] or tiny["launches_False"]["flash_fwd_pos"] <= 0:
        raise AssertionError("serve_gather: tiny-llama f32 streams differ, or no K3-pos launch")
    emit({"phase": "serve_gather", "preset": "llama3-8b-infer", "overrides": GATHER_OVERRIDES,
          "first_logits_rel_rms": rel, "tolerance": GATHER_LOGIT_REL,
          "gather_launches": {k: g["launches"][k] for k in GATHER_KERNELS},
          "paged_launches": {k: p["launches"][k] for k in GATHER_KERNELS},
          "prefill_tok_s": {"gather": g["prefill_tok_s"], "paged": p["prefill_tok_s"]},
          "ttft_s_median": {"gather": g["ttft"], "paged": p["ttft"]},
          "tiny_f32_streams_equal": True,
          "tiny_f32_k3pos_launches": tiny["launches_False"]["flash_fwd_pos"]})
    return g["launches"]


# serve_obs: the serve with the obs layer (orion_tpu_torch/obs) off and on,
# its sinks under chiprun_out/serve_obs/; then a NaN quarantine's flight
# dump. train_obs: the train with tracing, the flight recorder, the
# Prometheus file and a torch.profiler window.
OBS_NEW = 64
OBS_WAVES = 3          # the first captures the graphs; the others are timed
OBS_NAN_REQUESTS = 4
OBS_NAN_STEP = 2
OBS_SPAN_PATHS = ("prefill", "decode")
TRAIN_OBS_STEPS = 4
TRAIN_OBS_PROFILE = (2, 3)
TRAIN_OBS_PHASES = ("data", "dispatch", "train_step")
# K3, K7 and K8 by kernel name (the bf16 kernels and the f32 ones).
TRAIN_OBS_KERNELS = {"flash_fwd": ("flash_fwd_tc_kernel", "flash_fwd_kernel"),
                     "flash_dq": ("flash_dq_tc_kernel", "flash_dq_kernel"),
                     "flash_dkv": ("flash_dkv_tc_kernel", "flash_dkv_kernel")}


def obs_prompts(V):
    """The serve phase's 16 prompts (numpy seed 0, 100-2000 tokens)."""
    import numpy as np

    rng = np.random.default_rng(0)
    lens = np.linspace(100, 2000, 16).astype(int)
    return [rng.integers(0, V, size=n).tolist() for n in lens]


def obs_wave(eng, prompts, n_new):
    """Submit ``prompts`` together and drain the engine: (the requests, the
    drained timing, decode tokens/s over the decode dispatch spans, the
    median host share of a step that only decoded: 1 - its decode span
    over its wall)."""
    import torch

    reqs = [eng.submit_request(p, n_new) for p in prompts]
    shares = []
    while eng.has_work():
        d0, p0 = eng.timing["decode_s"], eng.timing["prefill_s"]
        t0 = time.perf_counter()
        eng.step()
        wall = time.perf_counter() - t0
        dec = eng.timing["decode_s"] - d0
        if dec > 0 and eng.timing["prefill_s"] == p0:
            shares.append(1 - dec / wall)
    torch.cuda.synchronize()
    tm = eng.reset_timing()
    decode_tokens = sum(len(r.generated) - 1 for r in reqs)
    return reqs, tm, decode_tokens / tm["decode_s"], statistics.median(shares)


def obs_serve(params, overrides, prompts, n_new, waves, injector=None):
    """A llama3-8b-infer engine (CUDA graphs) with ``overrides`` through
    ``waves`` waves of ``prompts``, then closed: each wave's (requests,
    timing, decode tok/s, host share), the launches, the executor's
    numbers and the engine's registry sections."""
    import torch

    from orion_tpu_torch import ops
    from orion_tpu_torch.config import get_config
    from orion_tpu_torch.infer import InferenceEngine

    eng = InferenceEngine(get_config("llama3-8b-infer", overrides), params, device="cuda",
                          fault_injector=injector)
    ops.reset_launches()
    out = [obs_wave(eng, prompts, n_new) for _ in range(waves)]
    launches = ops.launches()
    ex = eng._executor
    res = {"waves": out, "launches": launches, "runs": dict(ex.runs),
           "graphs": graph_stats(eng), "sections": eng.registry.sections(),
           "tracer": eng.tracer.metrics() if eng.tracer.enabled else None}
    faults = [{k: w[1][k] for k in ("dispatch_faults", "failed_steps", "pool_faults")}
              for w in out]
    if injector is None and any(any(f.values()) for f in faults):
        # reset_timing drained the counters require_no_faults reads.
        raise AssertionError(f"serve_obs: faults contained {faults}")
    eng.close()
    del eng
    free_engine()
    torch.cuda.synchronize()
    return res


def streams(reqs):
    return [(r.outcome, list(r.generated)) for r in reqs]


def check_serve_trace(d, res):
    """The traced serve's artifacts: the Chrome trace parses with nothing
    dropped, one dispatch/<path> span per executor run of the path, one
    step span per step, one first_token and one completed outcome per
    request; every metrics row and the Prometheus file carry the hbm
    gauges with 0 < bytes_in_use <= bytes_limit."""
    with open(os.path.join(d, "trace.json")) as f:
        doc = json.load(f)
    bad = []
    if doc["metadata"]["dropped_events"]:
        bad.append(f"{doc['metadata']['dropped_events']} events dropped")
    evs = [e for e in doc["traceEvents"] if e["ph"] != "M"]
    spans = {}
    for e in evs:
        if e["ph"] == "X":
            spans[e["name"]] = spans.get(e["name"], 0) + 1
    dispatch = {k[len("dispatch/"):]: n for k, n in spans.items() if k.startswith("dispatch/")}
    if dispatch != res["runs"] or set(dispatch) != set(OBS_SPAN_PATHS):
        bad.append(f"dispatch spans {dispatch}, executor runs {res['runs']}")
    steps = sum(w[1]["steps"] for w in res["waves"])
    if spans.get("step") != steps:
        bad.append(f"{spans.get('step')} step spans, {steps} steps")
    rids = [r.rid for w in res["waves"] for r in w[0]]
    for name in ("first_token", "outcome"):
        got = sorted(e["args"]["rid"] for e in evs if e["ph"] == "i" and e["name"] == name)
        if got != sorted(rids):
            bad.append(f"{name} instants for rids {got}")
    if any(e["args"]["outcome"] != "completed" for e in evs if e["name"] == "outcome"):
        bad.append("an outcome other than completed")
    with open(os.path.join(d, "m.jsonl")) as f:
        rows = [json.loads(x) for x in f]
    with open(os.path.join(d, "m.prom")) as f:
        prom = dict(line.rsplit(" ", 1) for line in f.read().splitlines())
    gauges = [(r["hbm.bytes_in_use"], r["hbm.bytes_limit"]) for r in rows]
    gauges.append((float(prom["orion_hbm_bytes_in_use"]), float(prom["orion_hbm_bytes_limit"])))
    if len(rows) != len(res["waves"]) + 1 or not all(0 < u <= lim for u, lim in gauges):
        bad.append(f"{len(rows)} metrics rows, hbm gauges {gauges}")
    if bad:
        raise AssertionError(f"serve_obs trace: {bad}")
    return {"events": len(evs), "spans": spans, "metrics_rows": len(rows),
            "hbm_gib": [u / 2 ** 30 for u, _ in gauges], "bytes_limit": gauges[0][1]}


def phase_serve_obs(params=None):
    """llama3-8b-infer at full width and depth with the serve's weights and
    16 requests, CUDA graphs on: untraced, then with inference.trace,
    trace_path, flight_dir, metrics_jsonl and metrics_prom under
    chiprun_out/serve_obs/, each engine through OBS_WAVES waves of the 16
    requests (the first captures the graphs; the later waves' decode
    tokens/s and host shares are printed). The traced streams equal the untraced
    ones, both run the same launches and graphs, and the artifacts hold
    (check_serve_trace). Then a NaN drive: 4 of the requests with the NaN
    guard, untraced, then traced with a flight recorder and a NaN injected
    at step OBS_NAN_STEP: one quarantine dump carrying the injected_fault
    event, the other 3 streams equal the clean run's. On the serve phase's
    ``params`` when given, else on the same seeded weights."""
    import glob
    import shutil

    import torch

    from orion_tpu_torch.config import get_config
    from orion_tpu_torch.models import init_params
    from orion_tpu_torch.runtime.fault import FaultInjector, FaultSpec

    mcfg = get_config("llama3-8b-infer").model
    if params is None:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        params = init_params(mcfg, gen, device="cuda", dtype="bfloat16")
    prompts = obs_prompts(mcfg.vocab_size)
    d = os.path.join(OUT_DIR, "serve_obs")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    sinks = ["inference.trace=true", f"inference.trace_path={d}/trace.json",
             f"inference.flight_dir={d}/flight", f"inference.metrics_jsonl={d}/m.jsonl",
             f"inference.metrics_prom={d}/m.prom"]
    t0 = time.perf_counter()
    plain = obs_serve(params, [], prompts, OBS_NEW, OBS_WAVES)
    traced = obs_serve(params, sinks, prompts, OBS_NEW, OBS_WAVES)
    serve_s = time.perf_counter() - t0
    bad = []
    if [streams(w[0]) for w in traced["waves"]] != [streams(w[0]) for w in plain["waves"]]:
        bad.append("traced streams differ from the untraced ones")
    if any(o != "completed" or len(g) != OBS_NEW for w in plain["waves"] for o, g in streams(w[0])):
        bad.append("an untraced request did not complete its tokens")
    if traced["launches"] != plain["launches"]:
        bad.append(f"launches {traced['launches']} != untraced {plain['launches']}")
    gkeys = ("captures", "replays")
    if [traced["graphs"][k] for k in gkeys] != [plain["graphs"][k] for k in gkeys]:
        bad.append(f"graphs {traced['graphs']} != untraced {plain['graphs']}")
    if plain["tracer"] is not None or "trace" in plain["sections"]:
        bad.append("the untraced engine holds a tracer")
    if bad:
        raise AssertionError(f"serve_obs: {bad}")
    arts = check_serve_trace(d, traced)

    # The NaN drive: clean, then traced with the flight recorder.
    nd = os.path.join(d, "nan")
    guard = ["inference.nan_guard=true"]
    t1 = time.perf_counter()
    clean = obs_serve(params, guard, prompts[:OBS_NAN_REQUESTS], OBS_NEW, 1)
    inj = FaultInjector([FaultSpec("nan", OBS_NAN_STEP)])
    hurt = obs_serve(params, guard + ["inference.trace=true", f"inference.flight_dir={nd}"],
                     prompts[:OBS_NAN_REQUESTS], OBS_NEW, 1, injector=inj)
    nan_s = time.perf_counter() - t1
    want, got = streams(clean["waves"][0][0]), streams(hurt["waves"][0][0])
    victims = [i for i, (o, _) in enumerate(got) if o == "error:nan"]
    dumps = glob.glob(os.path.join(nd, "flight_*.json"))
    doc = {}
    if len(dumps) == 1:
        with open(dumps[0]) as f:
            doc = json.load(f)
    kinds = [e["kind"] for e in doc.get("events", [])]
    if (inj.fired != [("nan", OBS_NAN_STEP, None)] or len(victims) != 1
            or [g for i, g in enumerate(got) if i not in victims]
            != [w for i, w in enumerate(want) if i not in victims]
            or any(o != "completed" for o, _ in want)
            or len(dumps) != 1 or doc.get("reason") != "nan_quarantine"
            or "injected_fault" not in kinds):
        raise AssertionError(f"serve_obs NaN drive: fired {inj.fired}, victims {victims}, "
                             f"dumps {dumps}, event kinds {kinds}")
    emit({"phase": "serve_obs", "preset": "llama3-8b-infer", "requests": len(prompts),
          "waves": OBS_WAVES, "new_tokens_each": OBS_NEW, "serve_s": serve_s, "nan_drive_s": nan_s,
          "trace": arts, "runs": traced["runs"], "graphs": traced["graphs"],
          "tracer": traced["tracer"], "sections": traced["sections"],
          "nan_drive": {"victim": victims[0], "dump": os.path.relpath(dumps[0], HERE),
                        "event_kinds": sorted(set(kinds)), "spans": len(doc["spans"])},
          "launches": traced["launches"]})
    timed = {name: res["waves"][1:] for name, res in (("untraced", plain), ("traced", traced))}
    emit({"phase": "serve_obs_overhead", "preset": "llama3-8b-infer",
          "waves_timed": OBS_WAVES - 1,
          **{f"decode_tok_s_{k}": [w[2] for w in ws] for k, ws in timed.items()},
          **{f"decode_host_share_{k}": [w[3] for w in ws] for k, ws in timed.items()},
          "nvidia_smi": smi_line()})
    return traced["launches"]


def profiled_kernels(path, step):
    """Kernels in a torch.profiler Chrome trace launched inside the
    ``train#<step>`` range: the host calls whose launch falls inside the
    range, matched to device kernels by correlation id. Returns (the range
    names present, kernel name -> count)."""
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    steps = sorted({e["name"] for e in evs if e.get("name", "").startswith("train#")})
    rng = [e for e in evs if e.get("name") == f"train#{step}" and e.get("ph") == "X"
           and e.get("cat") != "gpu_user_annotation"]
    if len(rng) != 1:
        raise AssertionError(f"train_obs: {len(rng)} host ranges train#{step} in {path}")
    lo, hi = rng[0]["ts"], rng[0]["ts"] + rng[0]["dur"]
    launched = {e["args"]["correlation"] for e in evs
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {}) and lo <= e["ts"] <= hi}
    count = {}
    for e in evs:
        if e.get("cat") == "kernel" and e.get("args", {}).get("correlation") in launched:
            count[e["name"]] = count.get(e["name"], 0) + 1
    return steps, count


def phase_train_obs(untraced_step_s=None):
    """llama-1b-bench at full width and depth, TRAIN_OBS_STEPS steps through
    Trainer.fit with train.trace, flight_dir, metrics_prom and
    profile_steps=TRAIN_OBS_PROFILE under chiprun_out/train_obs/: the trace
    holds one data, dispatch and train_step span a step, the flight
    recorder wrote nothing, the Prometheus file holds the train and hbm
    gauges, and the profiler's trace lists K3, K7 and K8 launched inside
    the train#2 range (and no other step's range). Prints the step time
    traced beside the train phase's (untraced)."""
    import glob
    import math
    import shutil

    import torch

    from orion_tpu_torch import ops
    from orion_tpu_torch.config import get_config
    from orion_tpu_torch.train import Trainer

    d = os.path.join(OUT_DIR, "train_obs")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    first, last = TRAIN_OBS_PROFILE
    cfg = get_config("llama-1b-bench", [
        f"train.num_steps={TRAIN_OBS_STEPS}", "train.log_interval=1", "train.trace=true",
        f"train.trace_path={d}/trace.json", f"train.flight_dir={d}/flight",
        f"train.metrics_prom={d}/m.prom", f"train.profile_steps=({first},{last})",
        f"train.profile_dir={d}/prof"])
    tr = Trainer(cfg, device="cuda")
    ops.reset_launches()
    t0 = time.perf_counter()
    hist = tr.fit()
    wall = time.perf_counter() - t0
    launches = ops.launches()
    losses = [m.loss for m in hist]
    with open(os.path.join(d, "trace.json")) as f:
        doc = json.load(f)
    names = [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"]
    counts = {p: names.count(p) for p in TRAIN_OBS_PHASES}
    with open(os.path.join(d, "m.prom")) as f:
        prom = dict(line.rsplit(" ", 1) for line in f.read().splitlines())
    [prof] = glob.glob(os.path.join(d, "prof", "*.json"))
    ranges, kernels = profiled_kernels(prof, first)
    by_kernel = {k: sum(n for name, n in kernels.items() if any(p in name for p in pats))
                 for k, pats in TRAIN_OBS_KERNELS.items()}
    bad = []
    if not all(math.isfinite(x) for x in losses):
        bad.append(f"non-finite loss {losses}")
    if counts != {p: TRAIN_OBS_STEPS for p in TRAIN_OBS_PHASES}:
        bad.append(f"phase spans {counts}")
    if doc["metadata"]["dropped_events"] or glob.glob(os.path.join(d, "flight", "*")):
        bad.append("dropped events or a flight dump")
    use, lim = float(prom["orion_hbm_bytes_in_use"]), float(prom["orion_hbm_bytes_limit"])
    if not (0 < use <= lim and "orion_train_loss" in prom):
        bad.append(f"prom hbm {use} / {lim}, train_loss {prom.get('orion_train_loss')}")
    if ranges != [f"train#{s}" for s in range(first, last)] or not all(by_kernel.values()):
        bad.append(f"profiled ranges {ranges}, kernels in train#{first} {by_kernel}")
    if bad:
        raise AssertionError(f"train_obs: {bad}")
    step_times = [m.step_time_s for m in hist]
    emit({"phase": "train_obs", "preset": "llama-1b-bench", "steps": len(hist),
          "losses": losses, "wall_s": wall, "phase_spans": counts,
          "trace_events": len(doc["traceEvents"]) - 1, "profiled_ranges": ranges,
          f"kernels_in_train#{first}": by_kernel,
          "profile_trace_mib": os.path.getsize(prof) / 2 ** 20,
          "prom_hbm_gib": use / 2 ** 30, "launches": launches})
    # Steps after the first (the fit's cold step) outside the profiled window.
    clean = [t for i, t in enumerate(step_times) if i and not first <= i < last]
    emit({"phase": "train_obs_overhead", "preset": "llama-1b-bench",
          "step_times_s_traced": step_times, "step_s_traced_unprofiled": clean,
          "step_s_median_traced_unprofiled": statistics.median(clean),
          "step_s_median_untraced": untraced_step_s, "nvidia_smi": smi_line()})
    del tr
    torch.cuda.empty_cache()
    return launches


def phase_serve_long():
    """Long context at Mistral-7B, full width and depth: two 8064-token
    requests at once over a 96-page pool (page rolling, residency
    demotion, preemption to the host), streams equal to the long_context
    off run over 300 pages."""
    import numpy as np
    import torch

    from orion_tpu_torch import ops
    from orion_tpu_torch.config import get_config
    from orion_tpu_torch.infer import InferenceEngine
    from orion_tpu_torch.models import init_params

    hbytes, avail = host_tier_budget()
    ov = LONG_OVERRIDES + [f"inference.host_tier_bytes={hbytes}"]
    cfg = get_config("mistral-7b-fsdp", ov)
    V = cfg.model.vocab_size
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg.model, gen, device="cuda", dtype="bfloat16")
    n_params = sum(t.numel() for t in tensor_leaves(params))
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, V, LONG_LEN).tolist() for _ in range(2)]
    warm = rng.integers(0, V, 600).tolist()
    eng = InferenceEngine(cfg, params, device="cuda")
    eng.generate([warm], 2)
    eng.reset_timing()
    peak = [0]
    alloc = eng.alloc

    def track():
        peak[0] = max(peak[0], alloc.num_pages - 1 - alloc.free_pages)

    reqs, res = serve_wave(eng, prompts, LONG_NEW, on_step=track)
    t = eng.reset_timing()
    rb = {k: t[k] for k in ("dispatch_faults", "failed_steps", "pool_faults")}
    if rb["dispatch_faults"] or rb["failed_steps"]:
        raise AssertionError(f"serve_long: faults {rb}")
    eng.assert_page_accounting()
    streams = [r.generated for r in reqs]
    rolled = sum(r.freed_until for r in reqs)
    preempted = eng.preemptions
    del eng
    free_engine()
    ref = InferenceEngine(get_config("mistral-7b-fsdp", LONG_REF_OVERRIDES), params,
                          device="cuda")
    ref.generate([warm], 2)
    ref_reqs, ref_res = serve_wave(ref, prompts, LONG_NEW)
    ref_streams = [r.generated for r in ref_reqs]
    del ref, params
    free_engine()
    if ref_streams != streams:
        raise AssertionError("serve_long: streams differ from the long_context-off run")
    if not (t["request_paged_out"] > 0 and t["request_paged_in"] > 0 and preempted > 0
            and rolled > 0 and peak[0] <= LONG_POOL - 1):
        raise AssertionError(f"serve_long: paging did not fire: {t}, preempted {preempted}, "
                             f"rolled {rolled}, peak {peak[0]}")
    emit({"phase": "serve_long", "preset": "mistral-7b-fsdp", "overrides": ov,
          "params": n_params, "setup_s": setup_s, "host_tier_bytes": hbytes,
          "mem_available_bytes": avail, "prompt_tokens_each": LONG_LEN,
          "pages_per_request": -(-(LONG_LEN + LONG_NEW) // cfg.inference.page_size),
          "pool_pages": LONG_POOL, "peak_device_pages": peak[0],
          "pages_rolled": rolled, "pages_demoted": t["request_paged_out"],
          "pages_restored": t["request_paged_in"], "preemptions": preempted,
          "page_in_s": t["page_in_s"], "spill_s": t["spill_s"],
          "page_in_s_per_step": t["page_in_s"] / t["steps"], **rb,
          "streams_equal_reference": True, **res,
          "reference": {k: ref_res[k] for k in ("ttft_s_median", "decode_tok_s",
                                                "prefill_tok_s", "wall_s")},
          "smi": smi_line()})
    missing = [k for k in ("rmsnorm_fwd", "rope_fwd", "flash_fwd", "paged_decode",
                           "paged_prefill") if res["launches"][k] <= 0]
    if missing:
        raise AssertionError(f"serve_long: kernels never launched: {missing}")
    return res["launches"]


def tensor_leaves(tree):
    """The tensors of a nested dict or list of tensors."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensor_leaves(v)
    else:
        yield tree


def phase_train_parity():
    import math

    import torch

    from orion_tpu_torch import ops
    from orion_tpu_torch.config import get_config
    from orion_tpu_torch.models import init_params
    from orion_tpu_torch.models.convert import tree_leaves_with_path, to_device
    from orion_tpu_torch.train import Trainer, loss_and_grads

    cfg = get_config("tiny-llama", TRAIN_PARITY_OVERRIDES)
    params = init_params(cfg.model, torch.Generator().manual_seed(0))
    runs = {}
    for dev in ("cuda", "cpu"):
        ops.reset_launches()
        tr = Trainer(cfg, params=params, device=dev)
        batch = tr.global_batch(0)
        loss, _, grads = loss_and_grads(to_device(params, dev), batch, cfg.model)
        runs[dev] = (float(loss), [g.cpu() for _, g in tree_leaves_with_path(grads)],
                     [m.loss for m in tr.fit()], ops.launches())
    (l1_g, g_g, losses_g, launches), (l1_c, g_c, losses_c, _) = runs["cuda"], runs["cpu"]
    missing = [k for k in TRAIN_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"train_parity: kernels never launched on cuda: {missing}")
    if abs(l1_g - l1_c) > TRAIN_TOL["loss_step1"]:
        raise AssertionError(f"train_parity: step-1 loss cuda {l1_g} cpu {l1_c}")
    atol, rtol = TRAIN_TOL["grads_step1"]
    grad_err = 0.0
    for a, b in zip(g_g, g_c):
        if not torch.allclose(a, b, atol=atol, rtol=rtol):
            raise AssertionError(f"train_parity: step-1 grads differ by {max_err(a, b)}")
        grad_err = max(grad_err, max_err(a, b))
    loss_err = max(abs(a - b) for a, b in zip(losses_g, losses_c))
    if not all(math.isfinite(x) for x in losses_g) or loss_err > TRAIN_TOL["loss"]:
        raise AssertionError(f"train_parity: losses cuda {losses_g} cpu {losses_c}")
    emit({"phase": "train_parity", "preset": "tiny-llama", "steps": len(losses_g),
          "losses_cuda": losses_g, "losses_cpu": losses_c, "max_loss_err": loss_err,
          "step1_grad_max_abs_err": grad_err, "tolerance": TRAIN_TOL})


def phase_train(profile=False):
    import math

    import torch

    from orion_tpu_torch import ops
    from orion_tpu_torch.config import get_config
    from orion_tpu_torch.train import Trainer

    cfg = get_config("llama-1b-bench", [f"train.num_steps={TRAIN_STEPS}",
                                        "train.log_interval=1"])
    tr = Trainer(cfg, device="cuda")
    # Warm-up step on a throwaway state (Triton JIT, cuBLAS heuristics).
    t0 = time.perf_counter()
    state = tr.init_state()
    tr.train_step(state, tr.global_batch(0))
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    del state
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    hist = tr.fit()
    launches = ops.launches()
    losses = [m.loss for m in hist]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: loss did not fall: {losses}")
    missing = [k for k in TRAIN_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"train: kernels never launched: {missing}")
    step_s = statistics.median(m.step_time_s for m in hist)
    tokens = tr.tokens_per_step
    emit({
        "phase": "train", "preset": "llama-1b-bench", "steps": len(hist),
        "params": cfg.model.num_params(), "tokens_per_step": tokens,
        "warmup_s": warmup_s, "losses": losses,
        "grad_norms": [m.grad_norm for m in hist],
        "step_times_s": [m.step_time_s for m in hist], "step_s_median": step_s,
        "tokens_per_s": tokens / step_s,
        "mfu": cfg.model.flops_per_token(cfg.data.seq_len) * tokens / step_s / BF16_FLOPS_S,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": launches,
        "launches_per_step": {k: n / len(hist) for k, n in launches.items()},
    })
    if profile:
        profile_train(tr, tr.state)
    del tr
    torch.cuda.empty_cache()
    return launches, step_s


# sp_rank: one rank of llama3-8b-256k-ring's striped ring at the preset's
# widths (its sp ring steps over S / sp queries a rank), the blocks sliced
# from a whole sequence on the card. Held against one positions-kernel
# call over the whole sequence for the rank's queries by relative RMS
# error: both sides round to bf16 (the ring each block's output and
# gradients, 16 of them summed), about 2^-8 apart on random inputs.
SP_PRESET, SP_REL = "llama3-8b-256k-ring", 2.0 ** -5


def rel_rms(a, b) -> float:
    """||a - b|| / ||b|| in float32."""
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm())


def check_sp_blocks(q, k, v, do, qpos, blocks, idx, G, gen):
    """K7-pos and K8-pos (after K3-pos, with a nonzero lse cotangent)
    against pos_grads_plain at the ring's shapes, within TOL: one kv-head
    group (kv head 0 and its G query heads) of the rank's 16384 striped
    queries over one ring step's 16384 striped keys, for the rank's own
    block and the next rank's, whose first stripe of queries attends
    nothing (those rows' dq must be exactly zero). The ring itself is held
    against one whole-sequence call of the same kernels, which a fault in
    either would pass. Returns max errors by kernel."""
    import torch

    c = q.shape[1] // len(blocks)  # queries a stripe
    qg, dog = (t[:, :, :G].contiguous() for t in (q, do))
    g_lse = torch.randn(1, G, q.shape[1], generator=gen, device="cuda")
    errs = {"flash_dq_pos": 0.0, "flash_dkv_pos": 0.0}
    for src in (idx, idx + 1):
        kb, vb = (t[:, blocks[src], :1].contiguous() for t in (k, v))
        kw = dict(q_positions=qpos[None], kv_positions=blocks[src][None].to(torch.int32),
                  causal=True)
        got = pos_grads_kernel(qg, kb, vb, dog, g_lse, kw)
        for name, t in zip(("dq", "dk", "dv"), got):
            if not torch.isfinite(t).all():
                raise AssertionError(f"sp_rank block {src}: non-finite {name}")
        if src > idx and got[0][:, :c].any():
            raise AssertionError(f"sp_rank block {src}: dq of rows that attend nothing "
                                 "is not zero")
        want = pos_grads_plain(qg, kb, vb, dog, g_lse, kw)
        errs["flash_dq_pos"] = max(errs["flash_dq_pos"],
                                   require_close("flash_dq_pos", "bfloat16", got[0], want[0]))
        errs["flash_dkv_pos"] = max(errs["flash_dkv_pos"], *(
            require_close("flash_dkv_pos", "bfloat16", a, b) for a, b in zip(got[1:], want[1:])))
        del kb, vb, got, want
        torch.cuda.empty_cache()
    return errs


def phase_sp_rank():
    """One rank (sp / 2) of the striped ring at llama3-8b-256k-ring's widths
    (32/8 heads, head_dim 128, S / sp = 16384 queries a rank over sp = 16
    steps of 16384 keys, batch 1, bf16): the port's _striped_ring (its
    _block_attend and _merge_blocks, the striped step order), forward and
    backward, with each step's kv block sliced from a whole sequence held
    on the card in place of the exchange. Held against one positions-kernel
    call (flash_attention_with_lse) over the whole sequence for the rank's
    queries: out, lse, dq, dk, dv. Counts the launches of the ring alone:
    sp each of K3-pos, K7-pos and K8-pos, and K3-pos's merge where its walk
    splits. Then holds K7-pos and K8-pos against their plain version on
    two of the ring's blocks (check_sp_blocks)."""
    import torch

    from orion_tpu_torch import ops
    from orion_tpu_torch.config import get_config
    from orion_tpu_torch.ops.flash_pos import grid_splits
    from orion_tpu_torch.parallel.sequence import _striped_ring, striped_positions

    cfg = get_config(SP_PRESET)
    if cfg.parallel.sequence_method != "ring_striped":
        raise AssertionError(f"{SP_PRESET}: sequence_method {cfg.parallel.sequence_method}")
    sp, S = cfg.parallel.sp, cfg.data.seq_len
    N, K, H = cfg.model.n_heads, cfg.model.n_kv_heads, cfg.model.resolved_head_dim
    s_loc, idx, dt = S // sp, sp // 2, torch.bfloat16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)

    q, k, v, do = rnd(1, s_loc, N, H), rnd(1, S, K, H), rnd(1, S, K, H), rnd(1, s_loc, N, H)
    qpos = striped_positions(idx, sp, s_loc, "cuda")
    blocks = [striped_positions(src, sp, s_loc, "cuda").long() for src in range(sp)]
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    at = {"src": idx}

    def rotate(k_, v_, seg):
        # The next step's block, (idx - t) mod sp, from the whole sequence.
        at["src"] = (at["src"] - 1) % sp
        return leaves[1][:, blocks[at["src"]]], leaves[2][:, blocks[at["src"]]], None

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    o, lse = _striped_ring(leaves[0], leaves[1][:, blocks[idx]], leaves[2][:, blocks[idx]],
                           None, None, idx=idx, sp=sp, rotate=rotate, causal=True,
                           logit_softcap=None)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    dq, dk, dv = torch.autograd.grad(o, leaves, do.float())
    torch.cuda.synchronize()
    bwd_s = time.perf_counter() - t0 - fwd_s
    launches = ops.launches()
    del leaves
    peak = torch.cuda.max_memory_allocated()

    ref = [t.detach().requires_grad_() for t in (q, k, v)]
    t0 = time.perf_counter()
    ro, rl = ops.flash_attention_with_lse(
        *ref, q_positions=qpos[None], causal=True,
        kv_positions=torch.arange(S, dtype=torch.int32, device="cuda")[None])
    rdq, rdk, rdv = torch.autograd.grad(ro, ref, do)
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t0
    errs = {}
    o, lse, ro, rl = o.detach(), lse.detach(), ro.detach(), rl.detach()
    for name, a, b in (("out", o, ro), ("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
        if not torch.isfinite(a).all():
            raise AssertionError(f"sp_rank: non-finite {name}")
        errs[name] = dict(rel_rms=rel_rms(a, b), max_abs_err=max_err(a, b))
        if errs[name]["rel_rms"] > SP_REL:
            raise AssertionError(f"sp_rank: {name} {errs[name]} against the whole call "
                                 f"exceeds the relative RMS {SP_REL}")
    errs["lse"] = dict(max_abs_err=require_close("flash_lse", "bfloat16", lse, rl))
    merges = sp if grid_splits(1, s_loc, s_loc, N, K) > 1 else 0
    want = {"flash_fwd_pos": sp, "flash_dq_pos": sp, "flash_dkv_pos": sp,
            "flash_fwd_pos_merge": merges}
    if any(launches[name] != n for name, n in want.items()):
        raise AssertionError(f"sp_rank: launches {launches} (want {want})")
    del o, lse, dq, dk, dv, ref, ro, rl, rdq, rdk, rdv
    torch.cuda.empty_cache()
    block_errs = check_sp_blocks(q, k, v, do, qpos, blocks, idx, N // K, gen)
    emit({"phase": "sp_rank", "preset": SP_PRESET, "sp": sp, "rank": idx, "seq_len": S,
          "queries_per_rank": s_loc, "heads": [N, K, H], "ring_steps": sp,
          "ring_fwd_s": fwd_s, "ring_bwd_s": bwd_s, "whole_call_s": whole_s,
          "peak_mem_gib": peak / 2 ** 30, "errors": errs, "tolerance_rel_rms": SP_REL,
          "launches": launches, "block_vs_plain": {
              "blocks": [idx, idx + 1], "heads": [N // K, 1, H], "max_abs_err": block_errs,
              "tolerance": {name: TOL[name]["bfloat16"] for name in block_errs}}})
    del q, k, v, do
    torch.cuda.empty_cache()
    return launches, block_errs


# train_faults: llama-1b-bench at full width and depth, random weights from
# train.seed, checkpoints in a temporary directory (at most two committed
# plus one being written: ~8.3 GB each).
TF_OVERRIDES = [f"train.num_steps={TRAIN_STEPS}", "train.log_interval=1",
                "checkpoint.save_interval_steps=2", "checkpoint.async_save=true",
                "checkpoint.max_to_keep=2"]
TF_POISON_KERNELS = ("rmsnorm_bwd", "rope_bwd", "flash_dq", "flash_dkv")
TF_PROMPTS = (100, 250, 400, 550)
TF_NEW = 16


class CkptClock:
    """Wall seconds of a checkpoint manager's saves (the synchronous part:
    stacking the layers and the device-to-host copy), commits (on the
    writer thread: bytes, write, fsync, CRC, manifest, rename, GC) and
    restores, by wrapping the manager's own methods."""

    def __init__(self):
        self.save_s, self.commit_s, self.restore_s = [], [], []

    def watch(self, mgr):
        save, commit, restore = mgr.save, mgr._commit, mgr.restore_latest

        def timed(fn, sink, keep=lambda out: True):
            def call(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                if keep(out):
                    sink.append(time.perf_counter() - t0)
                return out
            return call

        mgr.save = timed(save, self.save_s, keep=bool)
        mgr._commit = timed(commit, self.commit_s)
        mgr.restore_latest = timed(restore, self.restore_s, keep=lambda out: out is not None)
        return mgr

    def summary(self):
        med = lambda xs: statistics.median(xs) if xs else None  # noqa: E731
        return {"saves": len(self.save_s), "save_capture_s_median": med(self.save_s),
                "commits": len(self.commit_s), "commit_s_median": med(self.commit_s),
                "restores": len(self.restore_s), "restore_s": self.restore_s}


def manifest_of(ckpt_dir, step):
    with open(os.path.join(ckpt_dir, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def first_leaf_differing(m_a, m_b):
    """The first leaf (in file order) whose size or CRC differs, or None."""
    for key, entry in m_a["leaves"].items():
        other = m_b["leaves"].get(key)
        sig = [(s["nbytes"], s["crc32"]) for s in entry["shards"]]
        if other is None or sig != [(s["nbytes"], s["crc32"]) for s in other["shards"]]:
            return key
    return None


def state_leaves(state):
    """Params and moments of a port train state, in one list."""
    from orion_tpu_torch.models.convert import tree_leaves

    return tree_leaves(state["params"]) + tree_leaves(state["opt"]["mu"]) + \
        tree_leaves(state["opt"]["nu"])


def watch_poisoned_steps(tr, record):
    """Wrap the trainer's NaN-poisoned step: snapshot params and moments
    before it, and record whether it left them bitwise as they were, the
    schedule count, its flags and the K5-K8 launches inside it."""
    import torch

    from orion_tpu_torch import ops

    make = tr._poison_variant

    def variant():
        fn = make()

        def step(state, batch, limit):
            before = [t.clone() for t in state_leaves(state)]
            count, l0 = state["opt"]["count"], ops.launches()
            state, m = fn(state, batch, limit)
            torch.cuda.synchronize()
            l1 = ops.launches()
            record.append({
                "step": state["step"] - 1, "anomaly": m["anomaly"],
                "nonfinite": m["nonfinite"], "loss": m["loss"],
                "params_moments_bitwise_unchanged": all(
                    torch.equal(bits(a), bits(b)) for a, b in zip(before, state_leaves(state))),
                "count_unchanged": state["opt"]["count"] == count,
                "launches": {k: l1[k] - l0[k] for k in TF_POISON_KERNELS},
            })
            del before
            return state, m

        return step

    tr._poison_variant = variant


def tf_generate_streams(argv):
    """Run the serving CLI (``orion_tpu_torch.generate.main``) and return
    its first line and its streams."""
    import contextlib
    import io

    from orion_tpu_torch.generate import main as generate_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = generate_main(argv)
    lines = out.getvalue().strip().splitlines()
    if rc != 0:
        raise AssertionError(f"train_faults S: generate exited {rc}: {lines[-3:]}")
    return lines[0], [json.loads(line)["generated"] for line in lines if line.startswith("{")]


def tf_serve_check(cfg, ckpt_dir, params, step):
    """S: the CLI serves the checkpoint in ``ckpt_dir``; its greedy streams
    must equal an engine's built from ``params`` (the same run's final
    params, in memory)."""
    import numpy as np

    from orion_tpu_torch.infer import InferenceEngine
    from orion_tpu_torch.models.convert import to_device

    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.model.vocab_size, size=n).tolist() for n in TF_PROMPTS]
    argv = ["--preset", "llama-1b-bench", "--max-new-tokens", str(TF_NEW),
            f"checkpoint.directory={ckpt_dir}"]
    for p in prompts:
        argv += ["--tokens", ",".join(map(str, p))]
    t0 = time.perf_counter()
    head, cli = tf_generate_streams(argv)
    cli_s = time.perf_counter() - t0
    free_engine()
    if head != f"restored checkpoint step {step}":
        raise AssertionError(f"train_faults S: the CLI said {head!r}")
    eng = InferenceEngine(cfg, to_device(params, "cuda", dtype=cfg.model.dtype),
                          device="cuda")
    reqs = [eng.submit_request(p, TF_NEW) for p in prompts]
    while eng.has_work():
        eng.step()
    mem = [r.generated for r in reqs]
    eng.close()
    del eng
    free_engine()
    if cli != mem or any(len(g) != TF_NEW for g in mem):
        raise AssertionError(f"train_faults S: CLI streams {cli} != in-memory {mem}")
    return {"requests": len(prompts), "new_tokens_each": TF_NEW, "streams_equal": True,
            "cli_wall_s": cli_s}


def tf_guard_step_times(cfg, state, tr, pairs=8):
    """The guarded and the unguarded step on the same state and batches, in
    turns after one warm-up each: wall seconds a step (each ends in the
    step's host fetch), the median and every time."""
    import dataclasses

    from orion_tpu_torch.train import make_train_step

    on = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, anomaly_guard=True))
    off = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, anomaly_guard=False))
    fns = {"unguarded": make_train_step(off, tr._schedule),
           "guarded": make_train_step(on, tr._schedule)}
    args = {"unguarded": (), "guarded": (float("inf"),)}
    times = {k: [] for k in fns}
    for i in range(pairs + 1):
        for name in (("unguarded", "guarded") if i % 2 else ("guarded", "unguarded")):
            batch = tr.global_batch(i)
            t0 = time.perf_counter()
            state, _ = fns[name](state, batch, *args[name])
            if i:
                times[name].append(time.perf_counter() - t0)
    return {**{f"{k}_step_s_median": statistics.median(v) for k, v in times.items()},
            **{f"{k}_step_s": v for k, v in times.items()}}


def phase_train_faults():
    """R0-R3 and S (docstring) at llama-1b-bench; returns the phase's
    launches."""
    import dataclasses
    import math
    import shutil
    import tempfile

    import torch

    from orion_tpu_torch import ops
    from orion_tpu_torch.ckpt import CheckpointManager
    from orion_tpu_torch.config import get_config
    from orion_tpu_torch.runtime.fault import FaultInjector, FaultSpec, run_with_restarts
    from orion_tpu_torch.train import Trainer, abstract_train_state

    root = tempfile.mkdtemp(prefix="orion_train_faults_")
    du = shutil.disk_usage(root)
    smi = smi_line()
    emit({"phase": "train_faults", "disk_free_gib": du.free / 2 ** 30,
          "disk_total_gib": du.total / 2 ** 30, "nvidia_smi": smi})

    def cfg_for(name, *extra):
        return get_config("llama-1b-bench", TF_OVERRIDES + list(extra)
                          + [f"checkpoint.directory={root}/{name}"])

    def check_finite(name, hist):
        losses = [m.loss for m in hist]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"train_faults {name}: non-finite loss {losses}")
        return losses

    clock = CkptClock()
    out = {"phase": "train_faults", "preset": "llama-1b-bench", "steps": TRAIN_STEPS}
    ops.reset_launches()
    try:
        # R0: the uninterrupted fit.
        cfg0 = cfg_for("r0")
        tr0 = Trainer(cfg0, device="cuda")
        clock.watch(tr0.ckpt)
        t0 = time.perf_counter()
        r0_losses = check_finite("R0", tr0.fit())
        out["r0"] = {"wall_s": time.perf_counter() - t0, "losses": r0_losses,
                     "kept": tr0.ckpt._committed_steps()}
        r0_manifest = manifest_of(f"{root}/r0", TRAIN_STEPS)
        out["checkpoint_bytes"] = sum(s["nbytes"] for e in r0_manifest["leaves"].values()
                                      for s in e["shards"])
        out["checkpoint_files"] = len(r0_manifest["leaves"])
        # Restore of R0's final checkpoint, with and without the CRC pass
        # (the files were just written: the page cache holds them).
        restore = {}
        abstract = abstract_train_state(cfg0)
        for verify in (True, False):
            mgr = CheckpointManager(f"{root}/r0", dataclasses.replace(
                cfg0.checkpoint, verify_restore=verify))
            t0 = time.perf_counter()
            _, step = mgr.restore_latest(abstract)
            restore[f"verify_{str(verify).lower()}_s"] = time.perf_counter() - t0
            if step != TRAIN_STEPS:
                raise AssertionError(f"train_faults: restored step {step}")
        out["restore_to_host"] = restore
        # S: the CLI serves R0's checkpoint.
        out["s"] = tf_serve_check(cfg0, f"{root}/r0", tr0.state["params"], TRAIN_STEPS)
        del tr0
        free_engine()
        shutil.rmtree(f"{root}/r0")

        # R1: R0 under the supervisor, a fault at step 3.
        cfg1 = cfg_for("r1", "train.inject_fault_at_step=3")
        attempts, last = [], {"reason": None}

        def make_and_fit(attempt):
            tr = Trainer(cfg1, device="cuda")
            clock.watch(tr.ckpt)
            attempts.append({"attempt": attempt})
            t0 = time.perf_counter()
            state, step = tr.restore_or_init()
            attempts[-1].update(start_step=step, restore_or_init_s=time.perf_counter() - t0)
            try:
                return tr.fit(state=state, restart_info=(attempt, last["reason"]))
            finally:
                attempts[-1].update(tr.robustness.as_timing())
                attempts[-1]["quarantined"] = tr.ckpt.quarantined

        def on_retry(attempt, exc):
            last["reason"] = f"{type(exc).__name__}: {exc}"

        hist = run_with_restarts(make_and_fit, max_restarts=1, on_retry=on_retry)
        r1_losses = check_finite("R1", hist)
        r1_manifest = manifest_of(f"{root}/r1", TRAIN_STEPS)
        differ = first_leaf_differing(r0_manifest, r1_manifest)
        out["r1"] = {"attempts": attempts, "losses_resumed": r1_losses,
                     "final_state_bitwise_r0": differ is None, "first_differing_leaf": differ}
        if len(attempts) != 2 or attempts[0]["emergency_saves"] != 1 \
                or attempts[1]["start_step"] != 3 or attempts[1]["restarts"] != 1:
            raise AssertionError(f"train_faults R1: {attempts}")
        if differ is not None:
            emit(out)
            raise AssertionError(f"train_faults R1: the resumed final state differs from "
                                 f"R0's, first at leaf {differ}")
        if r1_losses != r0_losses[3:]:
            raise AssertionError(f"train_faults R1: losses {r1_losses} vs R0 {r0_losses}")
        free_engine()
        shutil.rmtree(f"{root}/r1")

        # R2: the guard, two NaN steps, the rollback.
        cfg2 = cfg_for("r2", "train.anomaly_guard=true", "train.anomaly_limit=2")
        inj = FaultInjector(specs=[FaultSpec("nan", 3, "train"), FaultSpec("nan", 4, "train")])
        tr2 = Trainer(cfg2, device="cuda", fault_injector=inj)
        clock.watch(tr2.ckpt)
        poisoned = []
        watch_poisoned_steps(tr2, poisoned)
        t0 = time.perf_counter()
        hist = tr2.fit()
        st = tr2.robustness
        out["r2"] = {"wall_s": time.perf_counter() - t0, "poisoned_steps": poisoned,
                     "losses": [m.loss for m in hist], "steps_logged": [m.step for m in hist],
                     "rolled_back_to": tr2.ckpt.last_restore_step,
                     "loader_offset": tr2.loader.offset, **st.as_timing()}
        if (st.rollbacks, st.skipped_batches, st.anomalous_steps, st.nonfinite_steps) \
                != (1, 1, 2, 2) or tr2.ckpt.last_restore_step != 4:
            raise AssertionError(f"train_faults R2: {out['r2']}")
        if [p["step"] for p in poisoned] != [3, 4] or not all(
                p["anomaly"] == 1.0 and p["nonfinite"] == 1.0
                and p["params_moments_bitwise_unchanged"] and p["count_unchanged"]
                and all(n > 0 for n in p["launches"].values()) for p in poisoned):
            raise AssertionError(f"train_faults R2: poisoned steps {poisoned}")
        nonfinite = [i for i, m in enumerate(hist) if not math.isfinite(m.loss)]
        if nonfinite != [3, 4] or hist[-1].step != TRAIN_STEPS:
            raise AssertionError(f"train_faults R2: non-finite losses at {nonfinite}, "
                                 f"last step {hist[-1].step}")
        del tr2, hist
        free_engine()
        shutil.rmtree(f"{root}/r2")

        # R3: a torn commit at step 4, then a fresh trainer's restore.
        cfg3 = cfg_for("r3", "train.num_steps=4")
        tr3 = Trainer(cfg3, device="cuda",
                      fault_injector=FaultInjector(specs=[FaultSpec("partial_write", 4)]))
        clock.watch(tr3.ckpt)
        check_finite("R3", tr3.fit())
        fired = list(tr3.fault_injector.fired)
        del tr3
        free_engine()
        tr3b = Trainer(cfg3, device="cuda")
        clock.watch(tr3b.ckpt)
        t0 = time.perf_counter()
        state, step = tr3b.restore_or_init()
        out["r3"] = {"fired": fired, "restored_step": step,
                     "quarantined": tr3b.ckpt.quarantined,
                     "corrupt_checkpoints": tr3b.robustness.corrupt_checkpoints,
                     "restore_or_init_s": time.perf_counter() - t0}
        if fired != [("partial_write", 4, "ckpt")] or step != 2 \
                or tr3b.ckpt.quarantined != [(4, "truncated_array")] \
                or tr3b.robustness.corrupt_checkpoints != 1:
            raise AssertionError(f"train_faults R3: {out['r3']}")
        out["step_times"] = tf_guard_step_times(cfg3, state, tr3b)
        del tr3b, state
        free_engine()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = ops.launches()
    missing = [k for k in TRAIN_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"train_faults: kernels never launched: {missing}")
    out.update(checkpoints=clock.summary(), launches={k: launches[k] for k in TRAIN_KERNELS},
               disk_free_gib_after=shutil.disk_usage(tempfile.gettempdir()).free / 2 ** 30,
               nvidia_smi=smi)
    emit(out)
    return launches


def time_ms(fn, runs=5, calls=5):
    """Time of one call: CUDA events around ``runs`` runs of ``calls``
    back-to-back calls after a warm-up, the median of the runs' per-call
    times. Within a run the host's work for a call overlaps the device's
    previous one, so a wrapper's host cost shows only where it exceeds
    its kernel's."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def graph_ms(fn, calls=20, runs=5):
    """Device time of one call alone: ``calls`` calls captured in a CUDA
    graph after a warm-up, the graph replayed ``runs`` times between CUDA
    events, the median per call. No host work runs between the kernels,
    so a wrapper's host cost never shows."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    return statistics.median(times)


def backward_ms(out, inputs, cotangent):
    """Time of one backward through a recorded graph (kept for reuse)."""
    import torch

    return time_ms(lambda: torch.autograd.grad(out, inputs, cotangent, retain_graph=True))


def train_timing(gen):
    """K6-K8, and K3 with its lse output, at the training path's shapes
    in bfloat16 (K5: norm_timing). The plain and library times of K7 and K8 are one
    backward computing dq, dk and dv together (autograd of the plain
    attention; SDPA's backward with enable_gqa)."""
    import torch
    import torch.nn.functional as F

    from orion_tpu_torch import ops

    dt = torch.bfloat16
    res = {}
    q, k, _, gq = t_attn_inputs(dt, gen)
    gk = torch.randn(k.shape, generator=gen, device="cuda").to(dt)
    pos = torch.arange(T_S, device="cuda", dtype=torch.int32).expand(T_B, T_S).contiguous()
    qr, kr = q.detach().requires_grad_(), k.detach().requires_grad_()
    outs = (ops.rope_plain(qr, pos, 500000.0), ops.rope_plain(kr, pos, 500000.0))
    nb = 2 * 2 * (q.numel() + k.numel()) + pos.numel() * 4
    res["rope_bwd"] = dict(
        ms=time_ms(lambda: (ops.rope_bwd_triton(gq, pos, 500000.0),
                            ops.rope_bwd_triton(gk, pos, 500000.0))),
        plain_ms=backward_ms(outs, [qr, kr], (gq, gk)),
        library_ms=None,
        bound=bound(nb, 6 * (q.numel() + k.numel()), F32_FLOPS_S))
    del q, k, gq, gk, qr, kr, outs
    torch.cuda.empty_cache()

    q, k, v, do = t_attn_inputs(dt, gen)
    pairs = T_B * T_N * T_S * (T_S + 1) // 2
    qkv_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())  # q, dO or out, k, v
    row_bytes = 2 * (T_B * T_N * T_S) * 4                   # lse, delta
    lib = [t.transpose(1, 2) for t in (q, k, v)]
    # K3 as the training path runs it (with lse), beside the K7/K8 rows.
    res["flash_fwd_train"] = dict(
        ms=time_ms(lambda: ops.flash_attention_cuda(q, k, v, causal=True, return_lse=True)),
        plain_ms=time_ms(lambda: ops.attention_plain(q, k, v, causal=True)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            *lib, is_causal=True, enable_gqa=True)),
        bound=bound(qkv_bytes + row_bytes // 2, 4 * HEAD * pairs, BF16_FLOPS_S))
    out, lse = ops.flash_attention_cuda(q, k, v, causal=True, return_lse=True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    plain = backward_ms(ops.attention_plain(*leaves, causal=True), leaves, do)
    del leaves
    torch.cuda.empty_cache()
    lib = [t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)]
    library = backward_ms(
        F.scaled_dot_product_attention(*lib, is_causal=True, enable_gqa=True), lib,
        do.transpose(1, 2))
    del lib
    torch.cuda.empty_cache()
    res["flash_dq"] = dict(
        ms=time_ms(lambda: ops.flash_dq_cuda(q, k, v, do, lse, delta, causal=True)),
        plain_ms=plain, library_ms=library,
        bound=bound(qkv_bytes + row_bytes + 2 * q.numel(), 6 * HEAD * pairs, BF16_FLOPS_S))
    res["flash_dkv"] = dict(
        ms=time_ms(lambda: ops.flash_dkv_cuda(q, k, v, do, lse, delta, causal=True)),
        plain_ms=plain, library_ms=library,
        bound=bound(qkv_bytes + row_bytes + 2 * (k.numel() + v.numel()), 8 * HEAD * pairs,
                    BF16_FLOPS_S))
    del q, k, v, do, out
    torch.cuda.empty_cache()
    return res


def k4_timing(gen, quant, last_pos):
    """K4 in bfloat16 (int8 pools under ``quant``) at 32 slots of
    ``last_pos``: time_ms and its device time alone (``device_ms``,
    graph_ms). Bytes: q and out, the new K/V read (and under int8
    written as int8 with its scales), every attended K/V element (and
    int8 scale) read once, the table and last_pos. The library yardstick
    is SDPA over the gathered context with a bool mask (bf16: K/V repeated
    over the G heads; int8: enable_gqa over the dequantized context); the
    gather and the dequantization are not timed."""
    import torch
    import torch.nn.functional as F

    from orion_tpu_torch import ops
    from orion_tpu_torch.ops.paged_attention import dequantize_pages

    dt = torch.bfloat16
    q, kp, vp, table, lp, kn, vn, base, sc = k4_inputs(dt, gen, quant, last_pos)
    kw = dict(layer_base=base, k_new=kn, v_new=vn, **sc)
    cuda = ops.paged_attention_int8_cuda if quant else ops.paged_attention_cuda
    ctx = int((lp.long() + 1).sum())
    if quant:
        nb = (2 * q.numel() * 2 + 2 * kn.numel() * (2 + 1) + 2 * B_DEC * N_KV * 4
              + 2 * ctx * N_KV * (HEAD + 4) + table.numel() * 4 + lp.numel() * 4)
    else:
        nb = (2 * q.numel() * 2 + 2 * kn.numel() * 2 + 2 * ctx * N_KV * HEAD * 2
              + table.numel() * 4 + lp.numel() * 4)
    P = table.shape[1]
    rows = base + table.long()
    kc, vc = ((dequantize_pages(pool[rows], s[rows], dt) if quant else pool[rows])
              .permute(0, 2, 1, 3, 4).reshape(B_DEC, N_KV, P * PSZ, HEAD)
              for pool, s in ((kp, sc.get("k_scale")), (vp, sc.get("v_scale"))))
    if not quant:
        kc = kc.repeat_interleave(N_HEADS // N_KV, dim=1)
        vc = vc.repeat_interleave(N_HEADS // N_KV, dim=1)
    dmask = (torch.arange(P * PSZ, device="cuda")[None] <= lp[:, None].long())[:, None, None]
    res = dict(
        ms=time_ms(lambda: cuda(q, kp, vp, table, lp, **kw)),
        device_ms=graph_ms(lambda: cuda(q, kp, vp, table, lp, **kw)),
        plain_ms=time_ms(lambda: ops.paged_attention_plain(q, kp, vp, table, lp, **kw)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kc, vc, attn_mask=dmask, enable_gqa=quant)),
        bound=bound(nb, 4 * N_HEADS * HEAD * ctx, BF16_FLOPS_S))
    del kc, vc, q, kp, vp, sc
    torch.cuda.empty_cache()
    return res


def decode_merge_timing(gen):
    """K4's merge at the kernels phase's K4 shapes (the slots' walks over
    splits of DECODE_SPLIT_PAGES pages), time_ms and device time alone
    (graph_ms). Bytes: the merged slots' partials
    (O and m, l of each active split) read once, their outputs written,
    last_pos read; no PyTorch call computes the same function."""
    from orion_tpu_torch import ops
    from orion_tpu_torch.ops.paged_attention import decode_active_splits

    o, ml, lp, out, kw = decode_merge_inputs(gen)
    act = [len(decode_active_splits(x, **kw)) for x in lp.tolist()]
    n_read = sum(n for n in act if n > 1)
    n_slots = sum(1 for n in act if n > 1)
    nb = n_read * N_HEADS * (HEAD + 2) * 4 + n_slots * N_HEADS * HEAD * 2 + B_DEC * 4
    res = {"paged_decode_merge": dict(
        ms=time_ms(lambda: ops.paged_decode_merge_cuda(o, ml, lp, out, **kw)),
        device_ms=graph_ms(lambda: ops.paged_decode_merge_cuda(o, ml, lp, out, **kw)),
        plain_ms=time_ms(lambda: ops.paged_decode_merge_plain(o, ml, lp, out, **kw)),
        library_ms=None,
        bound=bound(nb, 6 * n_read * N_HEADS * HEAD, F32_FLOPS_S))}
    del o, ml, out
    return res


def paged_prefill_timing(gen):
    """K9 in bfloat16 and over int8 pools at the chunked serve's shapes.
    Bytes: q and out, the chunk's K/V read and written (as int8 with its
    scales under int8), and the rows' real history pages read once;
    operations: 4 N H per attended (query, key) pair of the real queries.
    The library yardstick is SDPA with enable_gqa over the gathered
    (dequantized) history and the chunk, with a bool mask; the gather and
    the dequantization are not timed."""
    import torch
    import torch.nn.functional as F

    from orion_tpu_torch import ops
    from orion_tpu_torch.ops.paged_attention import dequantize_pages

    dt = torch.bfloat16
    res = {}
    for name, quant in (("paged_prefill", False), ("paged_prefill_int8", True)):
        q, kp, vp, walk, start, lens, kn, vn, base, sc, P_pre = k9_inputs(dt, gen, quant)
        kw = dict(n_prefix_pages=P_pre, layer_base=base, **sc)
        args = (q, kp, vp, walk, start, lens, kn, vn)
        cuda = ops.paged_flash_prefill_int8_cuda if quant else ops.paged_flash_prefill_cuda
        B, S = q.shape[:2]
        hist = sum(K9_STARTS)
        pairs = sum(n * st + n * (n + 1) // 2 for st, n in zip(K9_STARTS, K9_LENS))
        item = 1 if quant else 2
        nb = (2 * q.numel() * 2 + 2 * kn.numel() * (2 + item)
              + 2 * hist * N_KV * HEAD * item + walk.numel() * 4 + 2 * B * 4)
        if quant:
            nb += 2 * (kn.numel() // HEAD + hist * N_KV) * 4
        rows = base + walk[:, :P_pre].long()
        kpre, vpre = (pool[rows] if not quant else dequantize_pages(pool[rows], s[rows], dt)
                      for pool, s in ((kp, sc.get("k_scale")), (vp, sc.get("v_scale"))))
        kc, vc = (torch.cat([pre.permute(0, 1, 3, 2, 4).reshape(B, P_pre * PSZ, N_KV, HEAD),
                             new], dim=1).transpose(1, 2)
                  for pre, new in ((kpre, kn), (vpre, vn)))
        pos = start.long()[:, None] + torch.arange(S, device="cuda")
        pre_idx = torch.arange(P_pre * PSZ, device="cuda")
        kv_pos = torch.cat([pre_idx.expand(B, -1), pos], dim=1)
        seg = torch.arange(S, device="cuda")[None] < lens.long()[:, None]
        kv_seg = torch.cat([pre_idx[None] < start.long()[:, None], seg], dim=1)
        mask = ((pos[:, :, None] >= kv_pos[:, None]) & (seg[:, :, None] == kv_seg[:, None]))
        qt = q.transpose(1, 2)
        res[name] = dict(
            ms=time_ms(lambda: cuda(*args, **kw)),
            plain_ms=time_ms(lambda: ops.paged_flash_prefill_plain(*args, **kw)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qt, kc, vc, attn_mask=mask[:, None], enable_gqa=True)),
            bound=bound(nb, 4 * N_HEADS * HEAD * pairs, BF16_FLOPS_S))
        del q, kp, vp, kn, vn, kc, vc, kpre, vpre, sc, mask, qt, args
        torch.cuda.empty_cache()
    return res


def merge_timing(gen):
    """K9's merge at the kernels phase's shapes (rows merging 1/1/4/8
    splits). Bytes: the merged rows' partials (O and m, l of each active
    split) read once and their outputs written; no PyTorch call computes
    the same function."""
    from orion_tpu_torch import ops

    o, ml, start, out, kw = merge_inputs(gen)
    B, S, N, H = out.shape
    n_read = sum(n for n in merged_rows(start, kw) if n > 1)
    n_rows = sum(1 for n in merged_rows(start, kw) if n > 1)
    nb = n_read * S * N * (H + 2) * 4 + n_rows * S * N * H * 2 + B * 4
    res = {"paged_prefill_merge": dict(
        ms=time_ms(lambda: ops.paged_prefill_merge_cuda(o, ml, start, out, **kw)),
        plain_ms=time_ms(lambda: ops.paged_prefill_merge_plain(o, ml, start, out, **kw)),
        library_ms=None,
        bound=bound(nb, 6 * n_read * S * N * H, F32_FLOPS_S))}
    del o, ml, out
    return res


def k10_timing(gen, quant, shape):
    """K10 in bfloat16 (int8 pools under ``quant``) at ``shape``: time_ms
    and its device time alone (``device_ms``, graph_ms, kernel and merge),
    beside K4 at the same contexts (one K10 launch replaces W K4 launches
    of a verify-free decode; its first query's context, both timings).
    Bytes: q and out, the W tokens' K/V read and their real positions
    written (int8 with scales under int8), and every slot's committed
    context (positions below start) read once; operations: 4 N H per
    attended (real query, key) pair. The library yardstick is SDPA with
    enable_gqa over the gathered (dequantized) context with a bool mask
    [B, 1, W, ctx]; the gather is not timed."""
    import torch
    import torch.nn.functional as F

    from orion_tpu_torch import ops
    from orion_tpu_torch.ops.paged_attention import dequantize_pages
    from orion_tpu_torch.ops.ragged_paged_attention import verify_mask

    dt = torch.bfloat16
    q, kp, vp, table, start, lens, kn, vn, base, sc = k10_inputs(dt, gen, quant, **shape)
    kw = dict(layer_base=base, k_new=kn, v_new=vn, **sc)
    args = (q, kp, vp, table, start, lens)
    cuda = ops.ragged_verify_int8_cuda if quant else ops.ragged_verify_cuda
    k4 = ops.paged_attention_int8_cuda if quant else ops.paged_attention_cuda
    k4_kw = dict(kw, k_new=kn[:, 0], v_new=vn[:, 0])
    B, W = q.shape[:2]
    P = table.shape[1]
    cap = P * PSZ
    live = [(s, n) for s, n, pad in zip(shape["starts"], shape["lens"], shape["pad"]) if not pad]
    written = sum(min(s + n - 1, cap - 1) - s + 1 for s, n in live)
    ctx = sum(s for s, _ in live)
    pairs = sum(min(s + w, cap - 1) + 1 for s, n in live for w in range(n))
    item = 1 if quant else 2
    nb = (2 * q.numel() * 2 + 2 * kn.numel() * 2 + 2 * (written + ctx) * N_KV * HEAD * item
          + table.numel() * 4 + 2 * B * 4)
    if quant:
        nb += 2 * (written + ctx) * N_KV * 4
    rows = base + table.long()
    kc, vc = ((pool[rows] if not quant else dequantize_pages(pool[rows], s[rows], dt))
              .permute(0, 2, 1, 3, 4).reshape(B, N_KV, cap, HEAD)
              for pool, s in ((kp, sc.get("k_scale")), (vp, sc.get("v_scale"))))
    mask = verify_mask(start, W, cap)[:, None]
    qt = q.transpose(1, 2)
    res = dict(
        ms=time_ms(lambda: cuda(*args, **kw)),
        device_ms=graph_ms(lambda: cuda(*args, **kw)),
        plain_ms=time_ms(lambda: ops.ragged_paged_attention_plain(*args, **kw)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kc, vc, attn_mask=mask, enable_gqa=True)),
        k4_ms_same_contexts=time_ms(lambda: k4(q[:, 0], kp, vp, table, start, **k4_kw)),
        k4_device_ms_same_contexts=graph_ms(lambda: k4(q[:, 0], kp, vp, table, start,
                                                       **k4_kw)),
        bound=bound(nb, 4 * N_HEADS * HEAD * pairs, BF16_FLOPS_S))
    del q, kp, vp, kn, vn, kc, vc, sc, mask, qt, args, kw, k4_kw
    torch.cuda.empty_cache()
    return res


def ragged_verify_timing(gen):
    """K10 in bfloat16 and over int8 pools at the kernels phase's shapes
    and at the speculative serve's verify batch (``*_serve``), and its
    merge at the kernels phase's shapes (time_ms and device time alone;
    bytes: the merged slots' partials of each active split read once,
    their outputs written, start and lens read; no PyTorch call computes
    the same function)."""
    from orion_tpu_torch import ops

    res = {}
    for name, quant in (("ragged_verify", False), ("ragged_verify_int8", True)):
        res[name] = k10_timing(gen, quant, k10_main_shape())
        res[f"{name}_serve"] = k10_timing(gen, quant, k10_serve_shape())
    o, ml, start, lens, out, kw = verify_merge_inputs(gen)
    act = verify_merged(start, lens, kw)
    n_read = sum(n for n in act if n > 1)
    n_slots = sum(1 for n in act if n > 1)
    rows = K10_W * N_HEADS
    nb = n_read * rows * (HEAD + 2) * 4 + n_slots * rows * HEAD * 2 + 2 * B_DEC * 4
    res["ragged_verify_merge"] = dict(
        ms=time_ms(lambda: ops.ragged_verify_merge_cuda(o, ml, start, lens, out, **kw)),
        device_ms=graph_ms(lambda: ops.ragged_verify_merge_cuda(o, ml, start, lens, out, **kw)),
        plain_ms=time_ms(lambda: ops.ragged_verify_merge_plain(o, ml, start, lens, out, **kw)),
        library_ms=None,
        bound=bound(nb, 6 * n_read * rows * HEAD, F32_FLOPS_S))
    del o, ml, out
    return res


def host_us(fn, calls=1000):
    """The host's microseconds per call: wall time of ``calls`` back-to-back
    calls with one synchronize at the end, over ``calls`` (a call's device
    time where that is the longer)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def norm_timing(gen):
    """K1 in bfloat16 at the kernels phase's [8192, 4096], the training
    rows [16384, 2048] (``_train``) and the serve's decode batch [32, 4096]
    (``_decode``); K5 with the scale gradient (the kernel and the sum of
    its partial rows) at the training rows. Each: time_ms, its device time
    alone (graph_ms) and host_us. Plain: the plain forward, autograd of it
    for dx and dscale; library: F.rms_norm, and its backward with input and
    weight requiring grad. Bytes: x (and g) read, y (dx) written, the scale
    read; K5 also dscale written in the scale's dtype (what (dx, dscale)
    needs: the float32 partial rows are this kernel's own traffic, counted
    in ``partial_rows`` and not in the bound); operations (float32): 4 (K1)
    and 10 (K5) an element."""
    import torch
    import torch.nn.functional as F

    from orion_tpu_torch import ops

    dt = torch.bfloat16
    res = {}
    for name, (R, D) in (("rmsnorm_fwd", (K1_ROWS, D_MODEL)),
                         ("rmsnorm_fwd_train", (T_B * T_S, T_D)),
                         ("rmsnorm_fwd_decode", (B_DEC, D_MODEL))):
        x = torch.randn(R, D, generator=gen, device="cuda").to(dt)
        s = (1.0 + 0.1 * torch.randn(D, generator=gen, device="cuda")).to(dt)
        res[name] = dict(
            ms=time_ms(lambda: ops.rmsnorm_cuda(x, s, 1e-5)),
            device_ms=graph_ms(lambda: ops.rmsnorm_cuda(x, s, 1e-5)),
            host_us=host_us(lambda: ops.rmsnorm_cuda(x, s, 1e-5)),
            plain_ms=time_ms(lambda: ops.rmsnorm_plain(x, s, 1e-5)),
            library_ms=time_ms(lambda: F.rms_norm(x, (D,), s, 1e-5)),
            bound=bound(2 * x.numel() * 2 + D * 2, 4 * x.numel(), F32_FLOPS_S))
    x, s, g = t_norm_inputs(dt, gen)
    xr, sr = x.detach().requires_grad_(), s.detach().requires_grad_()
    n_part = ops.rmsnorm_bwd_partials(x, s, g, 1e-5, True)[1].shape[0]
    nb = 3 * x.numel() * x.element_size() + 2 * T_D * s.element_size()

    def k5():
        return ops.rmsnorm_bwd_cuda(x, s, g, 1e-5, True)

    res["rmsnorm_bwd"] = dict(
        ms=time_ms(k5), device_ms=graph_ms(k5), host_us=host_us(k5),
        plain_ms=backward_ms(ops.rmsnorm_plain(xr, sr, 1e-5), [xr, sr], g),
        library_ms=backward_ms(F.rms_norm(xr, (T_D,), sr, 1e-5), [xr, sr], g),
        bound=bound(nb, 10 * x.numel(), F32_FLOPS_S), partial_rows=n_part)
    del x, g, xr, sr
    torch.cuda.empty_cache()
    return res


def bound(nbytes, flops, rate):
    tb, tf = nbytes / HBM_BYTES_S * 1e3, flops / rate * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


K3POS_WAS_MS = 0.857   # the first, unsplit kernel at these shapes (PERF.md kernel table)


def k3pos_timing(gen):
    """K3 with positions at the gather body's shapes (no window): the split
    kernel and its merge as the wrapper launches them (and its device time
    alone), the bound by operations over the (query, key) pairs the mask
    admits on the real rows; the library call is SDPA with enable_gqa and
    the bool mask of the same positions and segments. Then the merge alone
    on partials of the same shapes and the same plan (each block's active
    splits), bound by its bytes: each merged row's partials read once, its
    output and lse written."""
    import torch
    import torch.nn.functional as F

    from orion_tpu_torch import ops
    from orion_tpu_torch.ops.common import q_tile
    from orion_tpu_torch.ops.flash_pos import grid_splits, split_plan

    q, k, v, kw = k3pos_gather_inputs(torch.bfloat16, gen)
    pairs = k3pos_admitted_pairs(q, k, kw, None)
    tiles = k3pos_pairs(kw["q_positions"], kw["kv_positions"], kw["q_segment_ids"],
                        kw["kv_segment_ids"], None)
    nb = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * sum(t.numel() for t in kw.values())
    mask = ops.attention_mask(q.shape[1], k.shape[1], causal=True, **kw)[:, None]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    pos_args = (kw["q_positions"], kw["kv_positions"])
    seg_kw = dict(q_segment_ids=kw["q_segment_ids"], kv_segment_ids=kw["kv_segment_ids"],
                  seg_pad_zero=True)
    B, S, N, H = q.shape
    n_sp = grid_splits(B, S, k.shape[1], N, N_KV)
    _, n_act = split_plan(*(t.cpu() for t in (kw["q_positions"], kw["kv_positions"],
                                              kw["q_segment_ids"], kw["kv_segment_ids"])),
                          n_heads=N, n_kv_heads=N_KV, seg_pad_zero=True, n_splits=n_sp)

    def fwd():
        return ops.flash_attention_pos_cuda(q, k, v, *pos_args, **seg_kw)

    res = {"flash_fwd_pos": dict(
        ms=time_ms(fwd), device_ms=graph_ms(fwd),
        plain_ms=time_ms(lambda: ops.attention_plain(q, k, v, **kw)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)),
        bound=bound(nb, 4 * HEAD * N_HEADS * pairs, BF16_FLOPS_S), pairs_admitted=pairs,
        pairs_in_first_kernel_tiles=tiles, was_ms=K3POS_WAS_MS, n_splits=n_sp,
        n_act=n_act.flatten().tolist())}
    del q, k, v, qt, kt, vt, mask

    tq = q_tile(N // N_KV)
    o = torch.randn(n_sp, B, S, N, H, generator=gen, device="cuda")
    ml = torch.rand(n_sp, B, S, N, 2, generator=gen, device="cuda") + 0.5
    n_act = n_act.to(device="cuda", dtype=torch.int32)
    out = torch.empty(B, S, N, H, dtype=torch.bfloat16, device="cuda")
    lse = torch.empty(B, N, S, device="cuda")
    blocks = n_act.repeat_interleave(tq, dim=1)[:, :S]                 # [B, S] splits read
    n_read = int(blocks[blocks > 1].sum()) * N
    n_rows = int((blocks > 1).sum()) * N
    mb = n_read * (H + 2) * 4 + n_rows * (H * 2 + 4) + n_act.numel() * 4

    def merge():
        return ops.flash_pos_merge_cuda(o, ml, n_act, out, lse, tq=tq)

    res["flash_fwd_pos_merge"] = dict(
        ms=time_ms(merge), device_ms=graph_ms(merge),
        plain_ms=time_ms(lambda: ops.flash_pos_merge_plain(o, ml, n_act, out, lse, tq=tq)),
        library_ms=None, bound=bound(mb, 6 * n_read * H, F32_FLOPS_S))
    del o, ml, out, lse
    torch.cuda.empty_cache()
    return res


def k78pos_timing(gen):
    """K7-pos and K8-pos in bfloat16 at the striped permutation on the
    training shapes (check_k3pos's layout, causal): each kernel's time and
    its device time alone, its bound from the (query, key) pairs the mask
    admits (the pairs any implementation must compute; a permutation of
    the positions admits the causal count, S(S+1)/2 a row and head) and the
    bytes each reads once (q, k, v, dO, lse, delta, the positions) and
    writes (dq; dk and dv). The plain and library times are one backward
    computing dq, dk and dv together (autograd of attention_plain with the
    positions; SDPA's backward with enable_gqa and the bool mask the
    positions make)."""
    import torch
    import torch.nn.functional as F

    from orion_tpu_torch import ops

    dt = torch.bfloat16
    q, k, v, kw = k3pos_striped_inputs(dt, gen)
    qpos, kpos = kw["q_positions"], kw["kv_positions"]
    do = torch.randn(q.shape, generator=gen, device="cuda").to(dt)
    out, lse = ops.flash_attention_pos_cuda(q, k, v, qpos, kpos, return_lse=True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    mask = ops.attention_mask(T_S, T_S, causal=True, **kw)
    pairs = int(mask.sum()) * T_N
    io = 2 * (2 * q.numel() + k.numel() + v.numel()) + 2 * 4 * lse.numel() \
        + 4 * (qpos.numel() + kpos.numel())
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    plain = backward_ms(ops.attention_plain(*leaves, **kw), leaves, do)
    del leaves
    torch.cuda.empty_cache()
    lib = [t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v)]
    library = backward_ms(F.scaled_dot_product_attention(*lib, attn_mask=mask[:, None],
                                                         enable_gqa=True),
                          lib, do.transpose(1, 2))
    del lib, mask
    torch.cuda.empty_cache()

    def dq():
        return ops.flash_dq_pos_cuda(q, k, v, do, lse, delta, qpos, kpos)

    def dkv():
        return ops.flash_dkv_pos_cuda(q, k, v, do, lse, delta, qpos, kpos)

    res = {
        "flash_dq_pos": dict(ms=time_ms(dq), device_ms=graph_ms(dq), plain_ms=plain,
                             library_ms=library, pairs_admitted=pairs,
                             bound=bound(io + 2 * q.numel(), 6 * HEAD * pairs, BF16_FLOPS_S)),
        "flash_dkv_pos": dict(ms=time_ms(dkv), device_ms=graph_ms(dkv), plain_ms=plain,
                              library_ms=library, pairs_admitted=pairs,
                              bound=bound(io + 2 * (k.numel() + v.numel()), 8 * HEAD * pairs,
                                          BF16_FLOPS_S)),
    }
    del q, k, v, do, out, lse, delta
    torch.cuda.empty_cache()
    return res


def phase_timing():
    import torch
    import torch.nn.functional as F

    from orion_tpu_torch import ops

    dt = torch.bfloat16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    res = {}

    res.update(norm_timing(gen))
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
    res.update(k3pos_timing(gen))

    for name, quant in (("paged_decode", False), ("paged_decode_int8", True)):
        res[name] = k4_timing(gen, quant, K4_LAST_POS)
        res[f"{name}_serve"] = k4_timing(gen, quant, K4_SERVE_LAST_POS)
    res.update(decode_merge_timing(gen))
    res.update(paged_prefill_timing(gen))
    res.update(merge_timing(gen))
    res.update(ragged_verify_timing(gen))
    res.update(train_timing(gen))
    res.update(k78pos_timing(gen))
    for name, r in res.items():
        extra = {k: v for k, v in r.items()
                 if k in ("k4_ms_same_contexts", "k4_device_ms_same_contexts", "device_ms",
                          "host_us", "partial_rows", "pairs_admitted",
                          "pairs_in_first_kernel_tiles", "was_ms", "n_splits", "n_act")}
        emit({"phase": "timing", "kernel": name, "dtype": "bfloat16", "ms": r["ms"],
              "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
              "bound_ms": r["bound"][0], "bound_by": r["bound"][1], **extra})
    return res


def extra_timing(name, timing):
    """K3 at the training path's shapes (with lse), K1 at the training
    rows and the serve's decode batch, K4 at the plain serve's decode batch
    and K10 at the speculative serve's verify batch, beside their main
    numbers in the kernels line, the device time alone where the timing
    phase took it (K1, K4, K5, K10 and the merges; K10 also beside K4 at
    the same contexts) and K1's and K5's host microseconds per call."""
    def device(r):
        return {k: r[k] for k in ("device_ms", "host_us") if k in r}

    out = device(timing[name])
    for key in ("k4_ms_same_contexts", "k4_device_ms_same_contexts"):
        if key in timing[name]:
            out[key] = timing[name][key]
    extra = {"flash_fwd": [("train_shapes", "flash_fwd_train")],
             "paged_decode": [("serve_shapes", "paged_decode_serve")],
             "paged_decode_int8": [("serve_shapes", "paged_decode_int8_serve")],
             "ragged_verify": [("serve_shapes", "ragged_verify_serve")],
             "ragged_verify_int8": [("serve_shapes", "ragged_verify_int8_serve")],
             "rmsnorm_fwd": [("train_shapes", "rmsnorm_fwd_train"),
                             ("decode_shapes", "rmsnorm_fwd_decode")]}
    for key, row in extra.get(name, ()):
        r = timing[row]
        out[key] = dict(ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
                        bound_by=r["bound"][1], library_ms=r["library_ms"], **device(r),
                        **{k: r[k] for k in ("k4_ms_same_contexts",
                                             "k4_device_ms_same_contexts") if k in r})
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--phases", default=",".join(PHASES),
                        help=f"comma-separated subset of {','.join(PHASES)}")
    parser.add_argument("--profile", action="store_true",
                        help="after the serve, the chunked serve and each drive of "
                             "the speculative serve, drive the same requests (the "
                             "later serves: their second wave) again, and after the "
                             "train, run two more steps, under torch.profiler "
                             "(tables in chiprun_out/)")
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
    if os.path.exists(os.path.join(OUT_DIR, "chip_smoke.jsonl")):
        os.remove(os.path.join(OUT_DIR, "chip_smoke.jsonl"))
    line = phase_device()
    errs = launches = chunked_launches = spec_launches = parity_launches = None
    train_launches = timing = fault_launches = constrained_launches = None
    train_fault_launches = graph_launches = sp_launches = None
    host_tier_launches = gather_launches = long_launches = None
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        errs = phase_kernels()
    if "parity" in phases:
        parity_launches = phase_parity()
    serve_params = None
    if "serve" in phases:
        launches, serve_params = phase_serve(args.profile)
        free_engine()
    if "serve_obs" in phases:
        phase_serve_obs(serve_params)
    if "serve_chunked" in phases:
        chunked_launches = phase_serve_chunked(args.profile, serve_params)
        free_engine()
    if "serve_spec" in phases:
        spec_launches = phase_serve_spec(serve_params, args.profile)
        free_engine()
    if "serve_constrained" in phases:
        constrained_launches = phase_serve_constrained(serve_params)
        free_engine()
    if "serve_faults" in phases:
        fault_launches = phase_serve_faults(serve_params)
        free_engine()
    if "serve_graphs" in phases:
        graph_launches = phase_serve_graphs(serve_params)
        free_engine()
    if "serve_host_tier" in phases:
        host_tier_launches = phase_serve_host_tier(serve_params)
        free_engine()
    if "serve_gather" in phases:
        gather_launches = phase_serve_gather(serve_params)
        free_engine()
    del serve_params
    free_engine()
    if "serve_long" in phases:
        # Mistral-7B's weights after the Llama weights are freed.
        long_launches = phase_serve_long()
        free_engine()
    if "train_parity" in phases:
        phase_train_parity()
    train_step_s = None
    if "train" in phases:
        train_launches, train_step_s = phase_train(args.profile)
    if "train_obs" in phases:
        phase_train_obs(train_step_s)
    if "train_faults" in phases:
        train_fault_launches = phase_train_faults()
    if "sp_rank" in phases:
        sp_launches, sp_errs = phase_sp_rank()
        if errs:
            # K7-pos's and K8-pos's errors at the ring's shapes too.
            for name, e in sp_errs.items():
                errs["bfloat16"][name] = max(errs["bfloat16"][name], e)
    if "timing" in phases:
        timing = phase_timing()
    if (errs and launches and chunked_launches and spec_launches and parity_launches
            and train_launches and sp_launches and timing):
        # A kernel on several paths counts its launches in each drive. K9's
        # bf16/f32 branch runs where chunked prefill or the prefix cache
        # serves a bf16/f32 pool: the float32 chunked parity drive (the
        # full-width chunked serve runs the int8 pool).
        by_path = {name: {"serve": launches[name], "serve_chunked": chunked_launches[name],
                          "serve_spec": spec_launches[name], "train": train_launches[name],
                          "parity_chunked_f32": parity_launches["float32"][name]}
                   for name in KERNEL_META}
        for path, counts in (("serve_constrained", constrained_launches),
                             ("serve_faults", fault_launches),
                             ("serve_graphs", graph_launches),
                             ("serve_host_tier", host_tier_launches),
                             ("serve_gather", gather_launches),
                             ("serve_long", long_launches),
                             ("train_faults", train_fault_launches),
                             ("sp_rank", sp_launches)):
            if counts:
                for name in KERNEL_META:
                    by_path[name][path] = counts[name]
        emit({"kernels": [
            dict(name=name, **KERNEL_META[name],
                 launches=sum(by_path[name].values()), launches_by_path=by_path[name],
                 max_abs_err=errs["bfloat16"][name], ms=timing[name]["ms"],
                 plain_ms=timing[name]["plain_ms"], bound_ms=timing[name]["bound"][0],
                 bound_by=timing[name]["bound"][1], library_ms=timing[name]["library_ms"],
                 **extra_timing(name, timing))
            for name in KERNEL_META
        ]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start, "phases": phases})
    print(line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
