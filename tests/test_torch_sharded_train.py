"""The sharded train step (``make_train_step(param_pspec=)``) against the
unsharded one on the CPU: one rank bit for bit, 2 and 4 gloo ranks
(``run_ranks``; a (1, 2) and a (2, 2) ("data", "model") mesh, one group
each for the whole module) at the tolerances the port holds against the
JAX package (``tests/test_torch_train.py``: metrics 1e-5, parameters 1e-4
after 2 Adam steps, here at the dry run's learning rate 1e-4, see
``torch_shard_ranks.LR``), and both steps' gradients element for element
at 1e-6, on the phi3-mini, qwen3 and (MoE) dbrx smoke configs, modes
``tp`` and ``fsdp``, ``grad_accum`` 1 and 2.  The 4-rank step is also held
to the reference's own sharded step (``repro.training.make_train_step(
param_pspec=)`` under ``jax.jit`` on a (2, 2) mesh of four host devices,
``torch_ref_sharded_main.py``) at the same tolerances.  The same groups check the
DTensor prefill and flash-decoding over a sequence-sharded cache (dense
qwen3 and MoE dbrx smoke configs) against the whole-tensor serving
functions, and ``make_hfl_train_step`` on a state
built with ``DTensor.from_local`` against the rank's plain replicas."""
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402

import torch_shard_ranks as ranks  # noqa: E402
from repro_torch.distributed import run_ranks  # noqa: E402
from repro_torch.training import make_train_step, adam  # noqa: E402

CASES = [(a, m, g) for a in ranks.ARCHS for m in ranks.MODES for g in ranks.ACCUMS]
SHAPES = {2: (1, 2), 4: (2, 2)}
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def unsharded():
    return {case: ranks.train(*case) for case in CASES}


@pytest.fixture(scope="module")
def reference_run():
    """The reference's sharded steps, started at once in a process of
    their own (they run while the gloo groups do)."""
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "ref")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(HERE, "..", "src"), HERE]))
        env.pop("XLA_FLAGS", None)
        proc = subprocess.Popen([sys.executable, os.path.join(HERE, "torch_ref_sharded_main.py"), prefix], env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            yield proc, prefix
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module")
def groups(reference_run):
    """One gloo group per rank count, every check in one call."""
    return {n: run_ranks(ranks.group_main, n, (shape,), threads=1, timeout=900) for n, shape in SHAPES.items()}


@pytest.fixture(scope="module")
def reference(reference_run):
    """case -> (metrics per step, parameter leaves after the steps) of the
    reference's sharded step."""
    proc, prefix = reference_run
    _, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-3000:]
    with open(prefix + ".json") as f:
        metrics = json.load(f)
    arrays = np.load(prefix + ".npz")
    out = {}
    for case in CASES:
        key = "|".join(map(str, case))
        n = sum(1 for k in arrays.files if k.startswith(key + "|"))
        out[case] = metrics[key], [arrays[f"{key}|{i}"] for i in range(n)]
    return out


def _one_rank_group():
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    assert dist.get_world_size() == 1


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c)) for c in CASES])
def test_one_rank_is_bit_equal_to_the_unsharded_step(case, unsharded):
    _one_rank_group()
    metrics, params, grads = ranks.train(*case, mesh=ranks.data_model_mesh((1, 1)))
    want_m, want_p, want_g = unsharded[case]
    assert metrics == want_m
    assert all(torch.equal(a, b) for a, b in zip(want_p, params, strict=True))
    for want, got in zip(want_g, grads, strict=True):
        assert all(torch.equal(a, b) for a, b in zip(want, got, strict=True))


@pytest.mark.parametrize("n", sorted(SHAPES))
@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c)) for c in CASES])
def test_ranks_agree_with_one_rank(case, n, unsharded, groups):
    want_m, want_p, want_g = unsharded[case]
    per_rank = [g["train"][case] for g in groups[n]]
    for metrics, params, grads in per_rank:
        for want, got in zip(want_g, grads, strict=True):  # each step's
            for a, b in zip(want, got, strict=True):
                torch.testing.assert_close(b, a, atol=1e-6, rtol=1e-5)
        for w, g in zip(want_m, metrics, strict=True):
            assert set(w) == set(g)
            for k in w:
                assert g[k] == pytest.approx(w[k], abs=1e-5, rel=1e-5), (k, w[k], g[k])
        for a, b in zip(want_p, params, strict=True):
            torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)
    first = per_rank[0][1]
    assert all(all(torch.equal(a, b) for a, b in zip(first, p)) for _, p, _ in per_rank)


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c)) for c in CASES])
def test_four_ranks_agree_with_the_reference_sharded_step(case, groups, reference):
    """The port's step on a (2, 2) mesh of gloo ranks against the
    reference's on a (2, 2) mesh of host devices: losses and gradient
    norms to 1e-5, parameters to 1e-4 after 2 steps."""
    want_m, want_p = reference[case]
    metrics, params, _ = groups[4][0]["train"][case]
    for w, g in zip(want_m, metrics, strict=True):
        assert set(w) == set(g)
        for k in w:
            assert g[k] == pytest.approx(w[k], abs=1e-5, rel=1e-5), (k, w[k], g[k])
    for a, b in zip(want_p, params, strict=True):
        np.testing.assert_allclose(b.float().numpy(), a, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("n", [1] + sorted(SHAPES))
def test_sgd_momentum_step_agrees_with_the_unsharded_one(n, groups):
    """The functional update (sgd, whose velocity the specs replicate):
    one rank bit for bit, 2 and 4 ranks at the tolerances above."""
    want_m, want_p, _ = ranks.train(*ranks.SGD_CASE, optimizer="sgd")
    if n == 1:
        _one_rank_group()
        metrics, params, _ = ranks.train(*ranks.SGD_CASE, ranks.data_model_mesh((1, 1)), optimizer="sgd")
        assert metrics == want_m
        assert all(torch.equal(a, b) for a, b in zip(want_p, params, strict=True))
        return
    for g in groups[n]:
        metrics, params, _ = g["sgd"]
        for w, m in zip(want_m, metrics, strict=True):
            for k in w:
                assert m[k] == pytest.approx(w[k], abs=1e-5, rel=1e-5), (k, w[k], m[k])
        for a, b in zip(want_p, params, strict=True):
            torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("n", sorted(SHAPES))
def test_sharded_prefill_and_decode_match_whole_tensors(n, groups):
    for g in groups[n]:
        assert g["serve"] < 1e-5


@pytest.mark.parametrize("n", sorted(SHAPES))
def test_hfl_step_on_from_local_state_is_the_plain_step(n, groups):
    results = [g["hfl"] for g in groups[n]]
    assert all(same for same, _ in results)
    first = results[0][1]
    assert all(all(torch.equal(a, b) for a, b in zip(first, p)) for _, p in results)


def test_sharded_step_refuses_whole_parameters():
    """Given a spec tree, the step takes DTensor parameters: whole tensors
    raise (no silent unsharded step)."""
    cfg = ranks.get_smoke_config("qwen3-14b")
    state = ranks.init_train_state(ranks.params_of(cfg), adam())
    step = make_train_step(cfg, adam(), param_pspec={})
    with pytest.raises(ValueError, match="DTensor"):
        step(state, ranks.batches(cfg)[0])
