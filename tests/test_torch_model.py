"""The port's CNN, loss, optimizer, cohort epoch, batch draws, shard store
and evaluation against the reference, on carried-across parameters and the
same numpy batches."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.engine.cohort import CohortPlan as RefCohortPlan  # noqa: E402
from repro.engine.cohort import _cohort_epoch as ref_cohort_epoch  # noqa: E402
from repro.engine.cohort import _cohort_epoch_flat as ref_cohort_epoch_flat  # noqa: E402
from repro.engine.flatten import FlatPack as RefFlatPack  # noqa: E402
from repro.federated import build_scenario as ref_build  # noqa: E402
from repro.federated.programs import CNNProgram as RefCNNProgram  # noqa: E402
from repro.federated.simulation import evaluate as ref_evaluate  # noqa: E402
from repro.models.cnn1d import cnn_apply as ref_cnn_apply  # noqa: E402
from repro.models.cnn1d import cnn_init as ref_cnn_init  # noqa: E402
from repro.training.loss import accuracy as ref_accuracy  # noqa: E402
from repro.training.loss import softmax_xent as ref_softmax_xent  # noqa: E402
from repro.training.optimizers import adam as ref_adam  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.engine.cohort import CohortPlan, _cohort_epoch_body, _cohort_epoch_flat  # noqa: E402
from repro_torch.engine.flatten import FlatPack  # noqa: E402
from repro_torch.engine.store import DeviceShardStore  # noqa: E402
from repro_torch.federated import build_scenario  # noqa: E402
from repro_torch.federated.programs import CNNProgram  # noqa: E402
from repro_torch.federated.simulation import evaluate  # noqa: E402
from repro_torch.models.cnn1d import HEARTBEAT_CNN, SEIZURE_CNN, cnn_apply  # noqa: E402
from repro_torch.training.loss import accuracy, softmax_xent  # noqa: E402
from repro_torch.training.optimizers import adam  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402


@pytest.fixture(scope="module")
def scenarios():
    kw = dict(scale=0.02, seed=0, n_test_per_class=20)
    return ref_build("heartbeat", **kw), build_scenario("heartbeat", device="cpu", **kw)


def _ref_params(cfg, seed=0):
    return jax.tree.map(np.asarray, ref_cnn_init(jax.random.PRNGKey(seed), cfg))


def _leaves_np(tree):
    return [l.detach().numpy() for l in tree_leaves(tree)]


@pytest.mark.parametrize("cfg", [HEARTBEAT_CNN, SEIZURE_CNN], ids=["heartbeat", "seizure"])
@pytest.mark.parametrize("impl", ["xla", "gemm"])
def test_cnn_apply_matches_reference(cfg, impl):
    ref = _ref_params(cfg, seed=1)
    x = np.random.default_rng(0).standard_normal((7, cfg.seq_len, cfg.in_channels)).astype(np.float32)
    want = np.asarray(ref_cnn_apply(ref, cfg, jnp.asarray(x), conv_impl=impl))
    got = cnn_apply(params_from_numpy(ref), cfg, torch.tensor(x), conv_impl=impl).numpy()
    assert got.shape == (7, cfg.n_classes)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_softmax_xent_and_accuracy_match_reference():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 10, 5)) * 3).astype(np.float32)
    labels = rng.integers(0, 5, (3, 10)).astype(np.int32)
    want = float(ref_softmax_xent(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(softmax_xent(torch.tensor(logits), torch.tensor(labels)))
    assert got == pytest.approx(want, abs=1e-6)
    assert float(accuracy(torch.tensor(logits), torch.tensor(labels))) == pytest.approx(
        float(ref_accuracy(jnp.asarray(logits), jnp.asarray(labels))), abs=1e-6
    )


def test_adam_step_matches_reference():
    rng = np.random.default_rng(0)
    ref = _ref_params(HEARTBEAT_CNN)
    grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32) * 1e-2, ref)
    ropt, topt = ref_adam(1e-3), adam(1e-3)
    rp, rstate = ref, ropt.init(ref)
    tp, tg = params_from_numpy(ref), params_from_numpy(grads)
    tstate = topt.init(tp)
    for step in range(3):
        rp, rstate = ropt.update(rp, grads, rstate, jnp.asarray(step, jnp.int32))
        tp, tstate = topt.update(tp, tg, tstate, step)
    for a, b in zip(_leaves_np(tp), jax.tree.leaves(rp)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=0)


def _cohort_inputs(scenario, c=3, steps=8, batch=10, seed=0):
    rng = np.random.default_rng(seed)
    clients = scenario.clients[:c]
    idx = [rng.integers(0, len(cl.shard), (steps, batch)) for cl in clients]
    xb = np.stack([cl.shard.x[i] for cl, i in zip(clients, idx)])
    yb = np.stack([cl.shard.y[i] for cl, i in zip(clients, idx)])
    return xb, yb


def test_cohort_epoch_flat_matches_reference(scenarios):
    ref_sc, _ = scenarios
    ref_rows = np.stack([
        np.asarray(RefFlatPack(_ref_params(HEARTBEAT_CNN, s)).ravel(_ref_params(HEARTBEAT_CNN, s)))
        for s in range(3)
    ])
    xb, yb = _cohort_inputs(ref_sc)
    rpack = RefFlatPack(_ref_params(HEARTBEAT_CNN))
    want, want_loss = ref_cohort_epoch_flat(
        jnp.asarray(ref_rows), jnp.asarray(xb), jnp.asarray(yb), rpack.spec, RefCNNProgram(), 8, 1e-3
    )
    tpack = FlatPack(params_from_numpy(_ref_params(HEARTBEAT_CNN)))
    start = torch.tensor(ref_rows)
    got, loss = _cohort_epoch_flat(start, torch.tensor(xb), torch.tensor(yb), tpack.spec, CNNProgram(), 8, 1e-3)
    assert torch.equal(start, torch.tensor(ref_rows))  # the input is not modified
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), atol=1e-5, rtol=0)


def test_cohort_epoch_body_matches_reference(scenarios):
    ref_sc, _ = scenarios
    trees = [_ref_params(HEARTBEAT_CNN, s) for s in range(3)]
    stacked = jax.tree.map(lambda *l: np.stack(l), *trees)
    xb, yb = _cohort_inputs(ref_sc, seed=1)
    want, want_loss = ref_cohort_epoch(
        jax.tree.map(jnp.asarray, stacked), jnp.asarray(xb), jnp.asarray(yb), RefCNNProgram(), 8, 1e-3
    )
    got, loss = _cohort_epoch_body(params_from_numpy(stacked), torch.tensor(xb), torch.tensor(yb), CNNProgram(), 8, 1e-3)
    for a, b in zip(_leaves_np(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=0)
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss), atol=1e-5, rtol=0)


@pytest.mark.parametrize("epochs", [1, 2])
def test_cohort_plan_draws_match_reference(scenarios, epochs):
    ref_sc, sc = scenarios
    active = np.ones(len(sc.clients), bool)
    active[[1, 4, 9]] = False
    rgroups, rpass = RefCohortPlan(ref_sc.clients, ref_sc.program).draw(np.random.default_rng(5), active, epochs)
    tgroups, tpass = CohortPlan(sc.clients, sc.program).draw(np.random.default_rng(5), active, epochs)
    np.testing.assert_array_equal(rpass, tpass)
    assert len(rgroups) == len(tgroups)
    for r, t in zip(rgroups, tgroups):
        np.testing.assert_array_equal(r.members, t.members)
        np.testing.assert_array_equal(r.idx, t.idx)
        assert (r.steps, r.batch, r.lr, r.epochs) == (t.steps, t.batch, t.lr, t.epochs)


def test_device_shard_store_gather_matches_numpy(scenarios):
    _, sc = scenarios
    store = DeviceShardStore(sc.clients, "cpu")
    rng = np.random.default_rng(0)
    cids = np.array([0, 3, 7, 11])
    idx = np.stack([rng.integers(0, len(sc.clients[i].shard), (2, 3)) for i in cids]).astype(np.int32)
    xb, yb = store.gather(cids, idx)
    assert tuple(xb.shape) == (4, 2, 3) + sc.clients[0].shard.x.shape[1:]
    for k, i in enumerate(cids):
        np.testing.assert_array_equal(xb[k].numpy(), sc.clients[i].shard.x[idx[k]])
        np.testing.assert_array_equal(yb[k].numpy(), sc.clients[i].shard.y[idx[k]])
    np.testing.assert_array_equal(store.sizes, [len(c.shard) for c in sc.clients])
    with pytest.raises(ValueError, match="cid"):
        DeviceShardStore(sc.clients[1:], "cpu")


def test_evaluate_matches_reference(scenarios):
    ref_sc, sc = scenarios
    ref = _ref_params(HEARTBEAT_CNN, seed=4)
    want = ref_evaluate(jax.tree.map(jnp.asarray, ref), ref_sc.program, ref_sc.test, batch=32)
    assert evaluate(params_from_numpy(ref), sc.program, sc.test, batch=32) == pytest.approx(want, abs=1e-6)
