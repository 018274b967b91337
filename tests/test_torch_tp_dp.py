"""The port's serving engine at tp = 2, dp = 2 (a world of four) on the
CPU against the JAX engine at the same mesh (``tests/test_infer.py::
test_sharded_engine_matches_unsharded``'s mesh).

Four gloo rank processes (``tests/torch_tp_worker.py``, one spawn for the
file) serve ``tests/test_torch_tp_serve.py``'s tiny-llama waves at float32
while the JAX engine serves them on four fake devices. The ranks that
differ only in ``dp`` are replicas: each builds its engine from the same
blocks as its tp peer in the other replica, and serves the same requests.
Held: every rank's greedy streams equal the JAX engine's exactly on plain
decode, chunked prefill with the prefix cache, int8 KV and chain and tree
speculation; each rank holds one kv head of every page; the two replicas
of a tp rank hold byte-equal pools at the end; every rank counts the same
collectives.
"""

import pytest
import torch

from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests import torch_tp_worker as W
from tests.test_torch_tp_serve import CASES, jax_streams, mesh_of, rank_cases

MESH = ["parallel.tp=2", "parallel.dp=2"]


@pytest.fixture(scope="module")
def served(tmp_path_factory, cpu_devices):
    jobs = rank_cases(CASES, MESH)
    for job in jobs:
        job["keep"] = job["id"] == "int8"
    tmp = tmp_path_factory.mktemp("tp2dp2")
    ctx = W.spawn(4, jobs, tmp)
    mesh = mesh_of(cpu_devices, tp=2, dp=2)
    want = {name: jax_streams(mesh, preset, ov, waves, n_new)[0]
            for name, (preset, ov, waves, n_new) in CASES.items()}
    ranks = W.collect(ctx, 4, tmp, timeout=300.0)
    for r in ranks:
        assert not r.pop("jax_imported")
    return want, ranks


@pytest.mark.parametrize("case", list(CASES))
def test_streams_match_jax_at_tp2_dp2(served, case):
    want, ranks = served
    coords = [(r[case]["coords"]["dp"], r[case]["coords"]["tp"]) for r in ranks]
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks:
        assert r[case]["streams"] == want[case], case
        assert r[case]["cache_shapes"]["k"][1] == 1
        assert r[case]["calls"] == ranks[0][case]["calls"]


def test_replicas_hold_the_same_pool(served):
    """dp replicas of a tp rank: byte-equal int8 pools and scale pools."""
    _, ranks = served
    for tp in (0, 1):
        a, b = ranks[tp]["int8"]["cache"], ranks[2 + tp]["int8"]["cache"]
        for name in a:
            assert torch.equal(a[name], b[name]), (tp, name)
