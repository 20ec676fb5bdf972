"""The edge mesh on the CPU: the port's ``MeshSyncEngine``,
``mesh_segment_mean``, ``edge_mesh`` and ``make_hfl_train_step`` against the
JAX package and the port's own engines, the port's counterpart of
``tests/test_hfl_mesh.py``.

One rank runs in this process (a one-rank gloo group); two and four ranks
run through ``run_ranks`` under gloo, both groups spawned once for the whole
file and side by side (``tests/torch_mesh_ranks.py`` holds their programs,
which import no JAX).  The population is the reference's engine-bench one
(24 EUs over 8 edges, the micro CNN), built once here and handed to the
ranks as an ``.npz``.  On this tree the reference's ``MeshSyncEngine`` runs
at one device (its heartbeat run fails on jax 0.9's ``shard_map``
scan-carry check, and the process sees one device), so the port is held to
it there and to the device pipeline everywhere, as the reference's own
contract holds its mesh: bit for bit at one rank, 1e-6 at more.
"""
import concurrent.futures
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_mesh_ranks as ranks  # noqa: E402
from benchmarks.engine_bench import _make_population  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.core.hfl import HFLSchedule as RefSchedule  # noqa: E402
from repro.distributed.hfl_mesh import init_hfl_state as ref_init_hfl_state  # noqa: E402
from repro.distributed.hfl_mesh import make_hfl_train_step as ref_make_hfl_train_step  # noqa: E402
from repro.engine.mesh_sim import MeshSyncEngine as RefMeshSyncEngine  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.training.optimizers import adam as ref_adam  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import CompressionSpec, HFLSchedule  # noqa: E402
from repro_torch.distributed import (  # noqa: E402
    edge_mesh,
    init_hfl_state,
    make_hfl_train_step,
    mesh_size,
    run_ranks,
)
from repro_torch.engine import BatchedSyncEngine, MeshSyncEngine, flat_segment_mean, mesh_segment_mean  # noqa: E402
from repro_torch.faults import FaultSpec  # noqa: E402
from repro_torch.federated import build_scenario  # noqa: E402
from repro_torch.federated.client import FLClient  # noqa: E402
from repro_torch.federated.programs import FedSGDProgram, MLPProgram  # noqa: E402
from repro_torch.federated.simulation import HFLSimulation  # noqa: E402
from repro_torch.training import adam, sgd  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402
from torch_parity import check_run, reference_inits  # noqa: E402

SCHEDULES = {"T1x2": (1, 2), "T2x2": (2, 2)}
RANK_TIMEOUT = 300.0
HFL_ARCH = "phi3-mini-3.8b"


@pytest.fixture(scope="module")
def pop(tmp_path_factory):
    """The population in both packages: the reference's clients, and the
    port's loaded back from the ``.npz`` the ranks read."""
    clients, asn, test, _latency, program, _ = _make_population(ranks.POP_M, ranks.POP_E)
    d = tmp_path_factory.mktemp("mesh")
    pop_path, init_path, hfl_path = str(d / "pop.npz"), str(d / "init.pt"), str(d / "hfl.pt")
    ranks.save_population(pop_path, clients, asn, test, dataclasses.asdict(program.cfg))
    torch.save(params_from_numpy(jax.tree.map(np.asarray, program.init(jax.random.PRNGKey(0)))), init_path)
    # the per-edge train step's setup (tests/test_hfl_mesh.py's): phi3 smoke, E 2, B 4, S 16
    cfg = ref_smoke(HFL_ARCH)
    params = ref_init_params(jax.random.PRNGKey(0), cfg)
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 4, 16), 0, cfg.vocab_size)
    batch = {"tokens": np.asarray(toks), "labels": np.asarray(jnp.roll(toks, -1, 2))}
    torch.save({"arch": HFL_ARCH, "params": params_from_numpy(jax.tree.map(np.asarray, params)),
                "batch": {k: torch.tensor(v) for k, v in batch.items()}}, hfl_path)
    return SimpleNamespace(
        ref=(clients, asn, test, program), port=ranks.load_population(pop_path),
        pop_path=pop_path, init_path=init_path, hfl_path=hfl_path, hfl_params=params, hfl_batch=batch,
    )


@pytest.fixture(scope="module")
def rank_runs(pop):
    """Both rank groups, started together before anything else runs here:
    {2: per-rank ``two_rank_extras``, 4: per-rank ``engine_rank``}."""
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        futures = {
            2: ex.submit(run_ranks, ranks.two_rank_extras, 2, (pop.pop_path, pop.init_path, pop.hfl_path),
                         timeout=RANK_TIMEOUT, threads=1),
            4: ex.submit(run_ranks, ranks.engine_rank, 4, (pop.pop_path, pop.init_path, 4),
                         timeout=RANK_TIMEOUT, threads=1),
        }
        yield futures


def _ranks(rank_runs, k):
    out = rank_runs[k].result()
    return [r["engine"] for r in out] if k == 2 else out


@pytest.fixture(scope="module")
def port_runs(pop, rank_runs):
    """Per schedule: the port's device pipeline and its mesh at one rank,
    from the reference's initial parameters (``mesh_report`` is the mesh's
    ``comm_report``)."""
    clients, asn, test, program = pop.port
    out = {}
    with reference_inits():
        for name, s in SCHEDULES.items():
            kw = dict(schedule=HFLSchedule(*s), seed=0, device="cpu")
            device = BatchedSyncEngine(clients, asn, program, test, pipeline="device", **kw).run(ranks.ROUNDS)
            eng = MeshSyncEngine(clients, asn, program, test, mesh=1, **kw)
            mesh = eng.run(ranks.ROUNDS)
            out[name] = SimpleNamespace(device=device, mesh=mesh, report=eng.comm_report())
    return out


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_mesh_one_rank_is_the_device_pipeline(port_runs, name):
    """One rank makes the device pipeline's kernel calls on the same rows:
    history, accounting and parameters bit for bit."""
    run = port_runs[name]
    got, want = ranks.summary(run.mesh), ranks.summary(run.device)
    assert got["accs"] == want["accs"] and got["losses"] == want["losses"]
    assert got["totals"] == want["totals"]
    np.testing.assert_array_equal(got["params"], want["params"])


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_mesh_matches_reference_mesh(pop, port_runs, name):
    """Against the reference's ``MeshSyncEngine(mesh=1)`` at the tolerances
    ``tests/test_torch_engine.py`` holds the device pipeline to: one local
    epoch, accuracy 1e-6; two (Adam restarts amplify the frameworks'
    summation orders), two test samples and the losses 5e-3; parameters
    5e-3 at both."""
    clients, asn, test, program = pop.ref
    want = RefMeshSyncEngine(clients, asn, program, test, schedule=RefSchedule(*SCHEDULES[name]), seed=0,
                             mesh=1).run(ranks.ROUNDS)
    n = len(test)
    two_epochs = SCHEDULES[name][0] == 2
    check_run(want, port_runs[name].mesh, acc_tol=2.0 / n + 1e-6 if two_epochs else 1e-6,
              loss_tol=5e-3 if two_epochs else 1e-5, param_tol=5e-3)


@pytest.mark.parametrize("k", [2, 4])
def test_mesh_matches_batched_sync(rank_runs, port_runs, k):
    """k gloo ranks: every rank returns the same result, with the one-rank
    run's accuracies and its parameters within 1e-6 (the per-rank batched
    epochs and the cloud reduce's association round differently)."""
    runs = _ranks(rank_runs, k)
    assert len(runs) == k
    for r in runs[1:]:
        assert r["accs"] == runs[0]["accs"] and r["losses"] == runs[0]["losses"]
        assert r["totals"] == runs[0]["totals"]
        np.testing.assert_array_equal(r["params"], runs[0]["params"])
    one = ranks.summary(port_runs["T2x2"].mesh)
    assert runs[0]["accs"] == one["accs"]
    assert runs[0]["totals"] == one["totals"]
    np.testing.assert_allclose(runs[0]["losses"], one["losses"], atol=1e-6, rtol=0)
    assert np.max(np.abs(runs[0]["params"] - one["params"])) <= 1e-6


@pytest.mark.parametrize("k", [1, 2, 4])
def test_mesh_comm_ledger_structure(rank_runs, port_runs, k):
    """The ledger shows the paper's structure: the edge round's programs
    (starts, cohort epoch, edge FedAvg) hand no byte to a collective, the
    cloud reduce runs once per cloud round with one payload, and the
    traffic is cross-edge only when the mesh splits the edges: one payload
    per cloud round, half of it per edge round at T 2 (within 5%: the loss
    gather adds its few bytes)."""
    rep = port_runs["T2x2"].report if k == 1 else _ranks(rank_runs, k)[0]["report"]
    progs = rep["programs"]
    assert {"edge_starts", "cohort_epoch", "edge_agg", "cloud_reduce", "loss_gather"} <= set(progs)
    for name in ("edge_starts", "cohort_epoch", "edge_agg"):
        assert progs[name]["coll_bytes_per_call"] == 0.0, (k, name)
        assert progs[name]["cross_edge_bytes_total"] == 0.0, (k, name)
    assert progs["cloud_reduce"]["calls"] == ranks.ROUNDS
    assert progs["cloud_reduce"]["coll_bytes_per_call"] == rep["payload_bytes"]
    assert progs["loss_gather"]["calls"] == ranks.ROUNDS
    assert rep["devices"] == k and rep["edges_per_device"] == ranks.POP_E // k
    assert rep["edge_rounds"] == ranks.ROUNDS * 2 and rep["cloud_syncs"] == ranks.ROUNDS
    if k == 1:
        assert rep["cross_edge_total_bytes"] == 0.0
    else:
        payload = rep["payload_bytes"]
        assert rep["cross_edge_bytes_per_cloud_round"] == pytest.approx(payload, rel=0.05)
        assert rep["cross_edge_bytes_per_edge_round"] == pytest.approx(payload / 2, rel=0.05)


def test_mesh_matches_readable_simulator(pop, port_runs):
    """The mesh also tracks the port's readable simulator (the same RNG
    discipline): accuracy 1e-6, parameters 1e-5."""
    clients, asn, test, program = pop.port
    with reference_inits():
        want = HFLSimulation(clients, asn, program, test, schedule=HFLSchedule(2, 2), seed=0,
                             device="cpu").run(ranks.ROUNDS)
    got = port_runs["T2x2"].mesh
    np.testing.assert_allclose([m.test_acc for m in got.history], [m.test_acc for m in want.history], atol=1e-6)
    np.testing.assert_allclose(ranks.flat(got.final_params), ranks.flat(want.final_params), atol=1e-5, rtol=0)


def test_mesh_rejects_unsupported(pop):
    """The reference's refusals, as ``ValueError``: dual connectivity, an
    edge count the mesh does not divide, faults, compression, upload
    quantization and more than one architecture group."""
    clients, asn, test, program = pop.port
    kw = dict(schedule=HFLSchedule(2, 2), seed=0, device="cpu")
    dca = asn.copy()
    dca[0, (asn[0].argmax() + 1) % ranks.POP_E] = 1.0  # client 0 on two edges
    with pytest.raises(ValueError, match="single-connectivity"):
        MeshSyncEngine(clients, dca, program, test, **kw)
    with pytest.raises(ValueError):
        MeshSyncEngine(clients, asn, program, test, mesh=3, **kw)  # 8 % 3, and one rank
    with pytest.raises(ValueError, match="fault"):
        MeshSyncEngine(clients, asn, program, test, faults=FaultSpec(seed=0), **kw)
    with pytest.raises(ValueError, match="compression"):
        MeshSyncEngine(clients, asn, program, test, compression=CompressionSpec("topk", fraction=0.1), **kw)
    fedsgd = FedSGDProgram(base=program, grad_bits=16)
    with pytest.raises(ValueError, match="quantization"):
        MeshSyncEngine([dataclasses.replace(c, program=fedsgd) for c in clients], asn, fedsgd, test, **kw)
    mlp = MLPProgram(feat=(program.cfg.seq_len, program.cfg.in_channels), classes=program.cfg.n_classes, hidden=16)
    mixed = [c if c.cid % 2 else FLClient(c.cid, c.shard, mlp) for c in clients]
    with pytest.raises(ValueError, match="one architecture group"):
        MeshSyncEngine(mixed, asn, program, test, **kw)


def test_edge_mesh_axis_and_bounds(monkeypatch):
    """A 1-D mesh named "edge" over the process's one rank (the one-rank
    group is created once and reused); the reference's bounds; the card by
    default (raising without CUDA)."""
    m = edge_mesh(1, device="cpu")
    assert m.mesh_dim_names == ("edge",)
    assert mesh_size(m) == 1 and m.get_local_rank("edge") == 0
    again = edge_mesh(device="cpu")
    assert again.get_group("edge") is m.get_group("edge") and mesh_size(again) == 1
    with pytest.raises(ValueError):
        edge_mesh(2, device="cpu")  # one rank in this process
    with pytest.raises(ValueError):
        edge_mesh(0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        edge_mesh(1)


def test_mesh_engine_defaults_to_the_card(pop, monkeypatch):
    clients, asn, test, program = pop.port
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MeshSyncEngine(clients, asn, program, test)


def test_scenario_mesh_pipeline_wires_comm_report():
    """``simulate(engine="sync", pipeline="mesh")`` (with telemetry) and
    ``mesh=1`` on the heartbeat scenario (the reference's counterpart fails
    on jax 0.9): ``comm_report`` set, the device pipeline's run bit for
    bit, and the mesh gauges and the reference's span names, tagged
    ``sync-mesh``."""
    sc = build_scenario("heartbeat", scale=0.02, seed=0, n_test_per_class=10, device="cpu")
    lam = sc.assign("eara-sca", device="cpu").lam
    want = sc.simulate(lam, 1, engine="sync", seed=0, device="cpu")
    assert want.comm_report is None
    for kw in ({"pipeline": "mesh", "telemetry": True}, {"mesh": 1}):
        res = sc.simulate(lam, 1, engine="sync", seed=0, device="cpu", **kw)
        assert res.comm_report["devices"] == 1
        assert "cloud_reduce" in res.comm_report["programs"]
        assert np.isfinite(res.history[-1].test_acc)
        assert [(m.test_acc, m.mean_local_loss) for m in res.history] == [
            (m.test_acc, m.mean_local_loss) for m in want.history]
        np.testing.assert_array_equal(ranks.flat(res.final_params), ranks.flat(want.final_params))
        if "telemetry" in kw:
            tel = res.telemetry
    gauges = tel.metrics.gauges
    assert gauges["mesh_devices"] == 1 and gauges["mesh_edges_per_device"] == sc.n_edges
    assert gauges["mesh_coll_bytes/cloud_reduce"] == 4 * sum(c.numel() for c in tree_leaves(want.final_params))
    assert gauges["mesh_cross_edge_bytes/cloud_reduce"] == 0.0
    spans = {(sp.name, sp.attrs.get("engine")) for sp in tel.tracer.spans}
    assert {("cloud_round", "sync-mesh"), ("cohort_epoch", "sync-mesh"), ("edge_aggregate", "sync-mesh")} <= spans
    assert ("cloud_reduce", None) in spans


def test_mesh_segment_mean_matches_references():
    """Ragged membership maps (hypothesis, 20 examples): one rank's
    ``mesh_segment_mean`` equals ``flat_segment_mean`` and numpy (grid-valued
    data: every summation order is exact in float32)."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    mesh = edge_mesh(1, device="cpu")
    e = ranks.POP_E

    @settings(max_examples=20, deadline=None)
    @given(st.integers(0, 24), st.integers(0, 2**31 - 1))
    def prop(rows, seed):
        rng = np.random.default_rng(seed)
        upd = rng.integers(-16, 17, (rows, 5)).astype(np.float32) / 4.0
        seg = rng.integers(0, e, rows)
        w = rng.integers(0, 9, rows).astype(np.float32) / 2.0
        want = ranks.segment_mean_numpy(upd, seg, w, e)
        got_flat = flat_segment_mean(torch.tensor(upd), torch.tensor(seg), torch.tensor(w), e).numpy()
        np.testing.assert_allclose(got_flat, want, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(mesh_segment_mean(mesh, upd, seg, w, e), want, atol=1e-5, rtol=1e-5)

    prop()


def test_mesh_segment_mean_on_two_ranks(rank_runs):
    """Two ranks, each averaging its four segments and assembling the whole
    (8, D) result: numpy's on every rank, on 20 fixed examples."""
    for r in rank_runs[2].result():
        assert r["segment_err"] <= 1e-5


# -- the per-edge train step --------------------------------------------------
@pytest.fixture(scope="module")
def hfl_runs(pop):
    """The reference's and the port's local step then sync step (E 2, one
    process), each state's leaves copied after each step."""
    cfg, ref_opt = ref_smoke(HFL_ARCH), ref_adam(1e-3)
    batch = jax.tree.map(jnp.asarray, pop.hfl_batch)
    state = ref_init_hfl_state(pop.hfl_params, ref_opt, 2)
    ref = []
    for sync in (False, True):
        state, m = jax.jit(ref_make_hfl_train_step(cfg, ref_opt, sync=sync))(state, batch)
        ref.append((jax.tree.map(np.asarray, state.params), jax.tree.map(np.asarray, state.opt_state),
                    {k: float(v) for k, v in m.items()}))
    port_cfg, opt = get_smoke_config(HFL_ARCH), adam(1e-3)
    tbatch = {k: torch.tensor(v) for k, v in pop.hfl_batch.items()}
    tstate = init_hfl_state(params_from_numpy(jax.tree.map(np.asarray, pop.hfl_params)), opt, 2)
    port = []
    for sync in (False, True):
        tstate, m = make_hfl_train_step(port_cfg, opt, sync=sync)(tstate, tbatch)
        port.append(([x.clone() for x in tree_leaves(tstate.params)], [x.clone() for x in tree_leaves(tstate.opt_state)],
                     {k: float(v) for k, v in m.items()}))
    return ref, port


def test_hfl_train_step_matches_reference(hfl_runs):
    """Local then sync step against the reference: the first step's Adam
    first moments (0.1 x the clipped per-edge gradients) 1e-6, i.e. the
    gradients 1e-5 (they agree to ~7e-9); the metrics 1e-5; the parameters
    after each step 1e-4 wherever the first step's gradient exceeds 5x
    Adam's eps (1e-8) on both replicas.  Adam's first step moves a
    parameter by lr * g / (|g| + eps), so where |g| is within a few eps of
    the gradients' rounding (one wq element of this batch has -2.7e-10
    against the port's 1.9e-9) the two packages move it by different
    fractions of lr; there the parameters are held to the most two Adam
    steps can move them apart, 2 x 2 x lr.  Such elements must stay under
    10% of the model."""
    ref, port = hfl_runs
    lr, conditioned = 1e-3, 5e-8
    first_moments = jax.tree.leaves(ref[0][1][0])
    clear = [np.abs(m / 0.1).min(axis=0, keepdims=True) > conditioned for m in first_moments]
    assert sum(int((~c).sum()) for c in clear) < 0.1 * sum(c.size for c in clear)
    for i, ((rp, _, rm), (tp, to, tm)) in enumerate(zip(ref, port)):
        for a, b, c in zip(jax.tree.leaves(rp), tp, clear, strict=True):
            c = np.broadcast_to(c, a.shape)
            np.testing.assert_allclose(b.numpy()[c], a[c], atol=1e-4, rtol=1e-4)
            np.testing.assert_allclose(b.numpy()[~c], a[~c], atol=4 * lr, rtol=0)
        if i == 0:
            for a, b in zip(first_moments, to[: len(first_moments)], strict=True):
                np.testing.assert_allclose(b.numpy(), a, atol=1e-6, rtol=1e-5)
        for key in ("total_loss", "grad_norm", "edge_loss_spread"):
            assert tm[key] == pytest.approx(rm[key], abs=1e-5, rel=1e-5), (i, key)


def test_replicas_diverge_then_sync(hfl_runs):
    """Non-IID per-edge batches make the replicas drift; the cloud sync
    makes them equal (eq. 8)."""
    _, port = hfl_runs
    local, synced = port[0][0], port[1][0]
    assert max(float((x[0] - x[1]).abs().max()) for x in local) > 0
    assert max(float((x[0] - x[1]).abs().max()) for x in synced) < 1e-6


def test_sync_opt_state_averages_the_moments(pop):
    """``sync_opt_state=True``: after a local and a sync step the replicas'
    Adam moments are equal too, each the replicas' mean."""
    opt = adam(1e-3)
    state = init_hfl_state(params_from_numpy(jax.tree.map(np.asarray, pop.hfl_params)), opt, 2)
    batch = {k: torch.tensor(v) for k, v in pop.hfl_batch.items()}
    cfg = get_smoke_config(HFL_ARCH)
    state, _ = make_hfl_train_step(cfg, opt, sync=False)(state, batch)
    local = [x.clone() for x in tree_leaves(state.opt_state)]
    state, _ = make_hfl_train_step(cfg, opt, sync=True, sync_opt_state=True)(state, batch)
    moments = tree_leaves(state.opt_state)
    assert max(float((x[0] - x[1]).abs().max()) for x in local) > 0
    for x in moments:
        np.testing.assert_array_equal(x[0].numpy(), x[1].numpy())


def test_sigma_weighted_cloud_average(pop):
    """Hand-divergent replicas (replica 1 shifted by 1) under weights (3, 1)
    and plain SGD at lr 0 (the local step moves nothing, so the sync alone
    acts): every replica becomes the reference's sigma-weighted average,
    ``tensordot(w / w.sum(), replicas)`` in float32 (1e-6)."""
    opt = sgd(0.0)
    tstate = init_hfl_state(params_from_numpy(jax.tree.map(np.asarray, pop.hfl_params)), opt, 2)
    for x in tree_leaves(tstate.params):
        x[1] += 1.0
    before = [x.numpy().copy() for x in tree_leaves(tstate.params)]
    got, _ = make_hfl_train_step(get_smoke_config(HFL_ARCH), opt, sync=True, edge_weights=torch.tensor([3.0, 1.0]))(
        tstate, {k: torch.tensor(v) for k, v in pop.hfl_batch.items()})
    w = np.asarray([0.75, 0.25], np.float32)
    for x, b in zip(before, tree_leaves(got.params), strict=True):
        np.testing.assert_array_equal(b[0].numpy(), b[1].numpy())
        np.testing.assert_allclose(b[0].numpy(), np.tensordot(w, x, axes=1), atol=1e-6, rtol=1e-6)


def test_hfl_two_ranks_equal_one(rank_runs, hfl_runs):
    """Two ranks, one edge replica each: the local and sync steps' metrics
    and each rank's replica equal the one-process run's (1e-6)."""
    _, port = hfl_runs
    for r, run in enumerate(rank_runs[2].result()):
        got = run["hfl"]
        for a, b in zip(port[1][0], got["params"], strict=True):
            np.testing.assert_allclose(b[0], a[r].numpy(), atol=1e-6, rtol=0)
        for want, m in zip((port[0][2], port[1][2]), got["metrics"]):
            for key in want:
                assert m[key] == pytest.approx(want[key], abs=1e-6), (r, key)
