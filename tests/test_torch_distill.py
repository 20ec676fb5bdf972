"""Heterogeneous-model federation: the port's distillation fuse
(``engine.distill``), mixed cohorts, ``build_scenario(model_mix=)``,
``HeteroHFLSimulation`` and the group-aware engines against the JAX package
on the same numpy inputs and initial parameters.

Parity of the engines is held at ``HFLSchedule(1, 1)`` and ``(2, 1)``:
at two local epochs and two edge rounds the two packages differ by float32
noise that Adam amplifies (``ROADMAP.md``, "Known difference")."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core.compression import CompressionSpec as RefCompressionSpec  # noqa: E402
from repro.data.synthetic_health import Dataset as RefDataset  # noqa: E402
from repro.engine import distill as ref_distill  # noqa: E402
from repro.engine.cohort import build_group_state as ref_build_group_state  # noqa: E402
from repro.engine.flatten import FlatPack as RefFlatPack  # noqa: E402
from repro.federated import build_scenario as ref_build_scenario  # noqa: E402
from repro.federated.programs import group_edge_sizes as ref_group_edge_sizes  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import CompressionSpec, HFLSchedule  # noqa: E402
from repro_torch.data.synthetic_health import Dataset  # noqa: E402
from repro_torch.engine import AsyncHFLEngine, BatchedSyncEngine, FlatPack, LocalJob, pack_for, run_cohorts  # noqa: E402
from repro_torch.engine.cohort import build_group_state  # noqa: E402
from repro_torch.engine.distill import (  # noqa: E402
    DistillSpec,
    check_distillable,
    check_public_shards,
    distill_edge,
    distill_fuse_flat,
    draw_public_batches,
    kd_loss,
    soft_targets,
)
from repro_torch.faults import FaultSpec  # noqa: E402
from repro_torch.federated import FLClient, HeteroHFLSimulation, build_scenario  # noqa: E402
from repro_torch.federated.programs import CNNProgram, FedSGDProgram, MLPProgram, group_edge_sizes  # noqa: E402
from repro_torch.federated.simulation import hetero_final_params  # noqa: E402
from repro_torch.models.cnn1d import CNNConfig  # noqa: E402
from repro_torch.serving import TrafficSpec  # noqa: E402
from torch_parity import (  # noqa: E402
    ReferencePopulation,
    check_run,
    flat,
    ref_flat,
    reference_costs,
    reference_inits,
    reference_program,
)

MIX = {"cnn": 12, "mlp": 6}
# local epochs capped at 4 steps: few step buckets, so the reference
# compiles few cohort shapes
CAPPED = [{"max_steps": 4}] * 18
BUILD = dict(scale=0.02, seed=0, n_test_per_class=10)
MICRO_CNN = CNNConfig(in_channels=1, n_classes=3, seq_len=16, c1=4, c2=4, hidden=8)
CHAOS = dict(p_drop=0.25, p_rejoin=0.5, p_fail=0.2, max_retries=2, backoff_s=0.1,
             energy_uploads=6.0, refade_rounds=1, drift_rate=0.05)


@pytest.fixture(scope="module")
def pair():
    """The mixed heartbeat population (12 CNN EUs, 6 MLP EUs) whose cost
    model is the reference's, the same population in the reference
    package, and its EARA-SCA assignment."""
    sc = build_scenario("heartbeat", model_mix=MIX, device="cpu", hparams=CAPPED, **BUILD)
    with reference_inits():
        ref = ReferencePopulation(sc)
        sc = dataclasses.replace(sc, cost=ref.cost)
        yield ref, sc, sc.assign("eara-sca", device="cpu").lam


def _micro_programs():
    return CNNProgram(MICRO_CNN), MLPProgram(feat=(MICRO_CNN.seq_len, MICRO_CNN.in_channels), classes=3, hidden=4)


def _edge_state(seed, n_edges):
    """The inputs of ``tests/test_distill.py::test_fuse_flat_matches_tree_reference``:
    per-group (E, D_g) matrices of the reference's inits at keys folded from
    ``seed``, for both packages."""
    progs = _micro_programs()
    key = jax.random.PRNGKey(seed)
    ref_mats, mats = [], []
    for g, prog in enumerate(progs):
        rp = reference_program(prog)
        pack = RefFlatPack(rp.init(jax.random.PRNGKey(0)))
        rows = np.stack([np.asarray(pack.ravel(rp.init(jax.random.fold_in(key, g * 17 + j)))) for j in range(n_edges)])
        ref_mats.append(jnp.asarray(rows))
        mats.append(torch.as_tensor(rows))
    return progs, [pack_for(p) for p in progs], mats, [reference_program(p) for p in progs], ref_mats


# -- programs ------------------------------------------------------------------
def test_apply_logits_defaults_to_apply_and_fedsgd_delegates():
    cnn, mlp = _micro_programs()
    params = mlp.init(torch.Generator().manual_seed(0))
    x = torch.randn((2,) + mlp.feat_shape, generator=torch.Generator().manual_seed(1))
    assert torch.equal(mlp.apply_logits(params, x), mlp.apply(params, x))
    assert torch.equal(FedSGDProgram(base=mlp).apply_logits(params, x), mlp.apply(params, x))
    stacked = {k: {n: v[None].expand(3, *v.shape) for n, v in leaf.items()} for k, leaf in params.items()}
    xs = x[None].expand(3, *x.shape)
    for prog in (mlp, FedSGDProgram(base=mlp)):
        assert torch.equal(prog.apply_logits_cohort(stacked, xs), mlp.apply_cohort(stacked, xs))


def test_group_edge_sizes_every_group(pair):
    """The per-group cloud weights of all G groups, floored at 1, equal the
    reference's."""
    ref, sc, lam = pair
    got = group_edge_sizes(sc.clients, lam, np.array([0] * 12 + [1] * 6))
    want = ref_group_edge_sizes(ref.clients, lam, np.array([0] * 12 + [1] * 6))
    assert len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# -- the fuse against the reference's ------------------------------------------
def test_soft_targets_and_kd_loss_match_reference():
    progs, packs, mats, ref_progs, ref_mats = _edge_state(seed=1, n_edges=1)
    spec = DistillSpec(steps=1, batch=5, temperature=2.0)
    x = np.random.default_rng(7).normal(size=(spec.batch, 16, 1)).astype(np.float32)
    params = [pk.unravel(m[0]) for pk, m in zip(packs, mats)]
    ref_params = [RefFlatPack(rp.init(jax.random.PRNGKey(0))).unravel(m[0]) for rp, m in zip(ref_progs, ref_mats)]
    got = soft_targets(progs, params, torch.as_tensor(x), spec.temperature)
    want = np.asarray(ref_distill.soft_targets(ref_progs, ref_params, jnp.asarray(x), spec.temperature))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    ref_spec = ref_distill.DistillSpec(**dataclasses.asdict(spec))
    for prog, p, rp, rpar in zip(progs, params, ref_progs, ref_params):
        loss = float(kd_loss(prog, p, torch.as_tensor(x), got, spec))
        assert loss == pytest.approx(float(ref_distill.kd_loss(rp, rpar, jnp.asarray(x), jnp.asarray(want), ref_spec)), abs=1e-6)


@pytest.mark.parametrize("form", ["tree", "flat"])
def test_fuse_matches_reference(form):
    """Both forms against the reference's on the inputs of its own flat-vs-
    tree pin (3 edges, 3 steps of 5, T 2, lr 1e-2): parameters within 1e-5,
    per-group losses within 1e-5; the port's flat form also against its own
    tree form within 1e-5."""
    progs, packs, mats, ref_progs, ref_mats = _edge_state(seed=1, n_edges=3)
    spec = DistillSpec(steps=3, batch=5, temperature=2.0, lr=1e-2)
    ref_spec = ref_distill.DistillSpec(**dataclasses.asdict(spec))
    xb = np.random.default_rng(7).normal(size=(3, spec.steps, spec.batch, 16, 1)).astype(np.float32)
    ref_packs = [RefFlatPack(rp.init(jax.random.PRNGKey(0))) for rp in ref_progs]
    flat_out, flat_losses = distill_fuse_flat(progs, [pk.spec for pk in packs], mats, torch.as_tensor(xb), spec)
    for j in range(3):
        tree_out, tree_losses = distill_edge(progs, [pk.unravel(m[j]) for pk, m in zip(packs, mats)], xb[j], spec)
        for g, pk in enumerate(packs):
            np.testing.assert_allclose(flat_out[g][j].numpy(), pk.ravel(tree_out[g]).numpy(), atol=1e-5)
        if form == "tree":
            ref_out, ref_losses = ref_distill.distill_edge(
                ref_progs, [pk.unravel(m[j]) for pk, m in zip(ref_packs, ref_mats)], xb[j], ref_spec
            )
            for g, (pk, rpk) in enumerate(zip(packs, ref_packs)):
                np.testing.assert_allclose(pk.ravel(tree_out[g]).numpy(), np.asarray(rpk.ravel(ref_out[g])), atol=1e-5)
            np.testing.assert_allclose(tree_losses, ref_losses, atol=1e-5)
    if form == "flat":
        ref_out, ref_losses = ref_distill.distill_fuse_flat(ref_progs, [pk.spec for pk in ref_packs], ref_mats, xb, ref_spec)
        for g in range(2):
            np.testing.assert_allclose(flat_out[g].numpy(), np.asarray(ref_out[g]), atol=1e-5)
        np.testing.assert_allclose([float(v) for v in flat_losses], ref_losses, atol=1e-5)


def test_fuse_reduces_kd_loss():
    """Students move toward the ensemble: on the same public batch each
    group's KD loss after the fuse is below the one before."""
    progs, packs, mats, _, _ = _edge_state(seed=2, n_edges=1)
    spec = DistillSpec(steps=8, batch=16, lr=5e-2)
    xb = torch.as_tensor(np.random.default_rng(3).normal(size=(1, spec.steps, spec.batch, 16, 1)).astype(np.float32))
    before = [pk.unravel(m[0]) for pk, m in zip(packs, mats)]
    targets = soft_targets(progs, before, xb[0, 0], spec.temperature).detach()
    fused, _ = distill_fuse_flat(progs, [pk.spec for pk in packs], mats, xb, spec)
    for prog, pk, b, f in zip(progs, packs, before, fused):
        assert float(kd_loss(prog, pk.unravel(f[0]), xb[0, 0], targets, spec)) < float(
            kd_loss(prog, b, xb[0, 0], targets, spec)
        )


def test_draw_public_batches_matches_reference():
    spec = DistillSpec(steps=3, batch=4)
    got = draw_public_batches(np.random.default_rng(5), [15, 7, 1], spec)
    want = ref_distill.draw_public_batches(np.random.default_rng(5), [15, 7, 1], ref_distill.DistillSpec(3, 4))
    assert got.dtype == np.int32 and got.shape == (3, 3, 4)
    np.testing.assert_array_equal(got, want)


# -- validation, with the reference's messages ------------------------------------
def _same_error(port_call, ref_call, exc=ValueError):
    with pytest.raises(exc) as got:
        port_call()
    with pytest.raises(exc) as want:
        ref_call()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(steps=0), dict(batch=0), dict(temperature=0.0)], ids=lambda kw: next(iter(kw)))
def test_distill_spec_validation(kw):
    _same_error(lambda: DistillSpec(**kw), lambda: ref_distill.DistillSpec(**kw))


@dataclasses.dataclass(frozen=True)
class _Stub:
    """Just the attributes ``check_distillable`` reads, for both packages."""

    n_classes: int = 3
    feat_shape: tuple = (16, 1)
    feat_dtype: object = np.float32
    cfg: object = None


@dataclasses.dataclass(frozen=True)
class _Vocab:
    vocab_size: int


@pytest.mark.parametrize("other", [
    _Stub(n_classes=5),
    _Stub(feat_shape=(8, 2)),
    _Stub(feat_dtype=np.int32),
    _Stub(cfg=_Vocab(64)),
], ids=["alphabet", "layout", "dtype", "vocab"])
def test_check_distillable(other):
    cnn, mlp = _micro_programs()
    check_distillable([cnn, mlp, _Stub()])  # one alphabet and layout: fine
    ref_distill.check_distillable([reference_program(cnn), reference_program(mlp)])
    _same_error(lambda: check_distillable([_Stub(), other]), lambda: ref_distill.check_distillable([_Stub(), other]))


def test_check_distillable_takes_torch_dtypes():
    check_distillable([_Stub(feat_dtype=torch.float32), _Stub(feat_dtype=np.float32)])
    with pytest.raises(ValueError, match="int32"):
        check_distillable([_Stub(feat_dtype=torch.int32), _Stub()])


@pytest.mark.parametrize("case", ["none", "count", "empty"])
def test_check_public_shards(case):
    shard = Dataset(np.zeros((2, 16, 1), np.float32), np.zeros(2, np.int32), 3)
    empty = Dataset(np.zeros((0, 16, 1), np.float32), np.zeros(0, np.int32), 3)
    shards = {"none": None, "count": [shard] * 2, "empty": [shard, empty, shard]}[case]
    ref_shards = None if shards is None else [RefDataset(s.x, s.y, s.n_classes) for s in shards]
    _same_error(lambda: check_public_shards(shards, 3), lambda: ref_distill.check_public_shards(ref_shards, 3))
    check_public_shards([shard] * 3, 3)


# -- mixed cohorts and group state ----------------------------------------------------
def test_run_cohorts_mixed_blocks_bit_identical_to_solo():
    """Mixed-program jobs give rows bit-identical to each architecture run
    alone, one block per program; ``gather`` across blocks and ``matrix``
    of a mixed result raise."""
    cnn, mlp = _micro_programs()
    rng = np.random.default_rng(0)
    shard = Dataset(rng.normal(size=(8, 16, 1)).astype(np.float32), rng.integers(0, 3, 8).astype(np.int32), 3)
    clients = [FLClient(i, shard, p) for i, p in enumerate([cnn, mlp, cnn, mlp])]
    starts = {p: pack_for(p).ravel(p.init(torch.Generator().manual_seed(1))) for p in (cnn, mlp)}

    def jobs_for(cs):
        return [LocalJob(c, starts[c.program], [np.random.default_rng(100 + c.cid).integers(0, 8, (1, 10))], steps=1)
                for c in cs]

    mixed = run_cohorts(jobs_for(clients), cnn, pack_for(cnn))
    assert len(mixed.blocks) == 2 and [b.shape[1] for b in mixed.blocks] == [pack_for(cnn).dim, pack_for(mlp).dim]
    solo_cnn = run_cohorts(jobs_for(clients[0::2]), cnn, pack_for(cnn))
    solo_mlp = run_cohorts(jobs_for(clients[1::2]), mlp, pack_for(mlp))
    for c in clients:
        solo = solo_cnn if c.program == cnn else solo_mlp
        assert torch.equal(mixed.row(c.cid), solo.row(c.cid))
        assert mixed.loss[c.cid] == solo.loss[c.cid]
    assert torch.equal(mixed.gather([0, 2]), solo_cnn.matrix)
    with pytest.raises(ValueError):
        mixed.gather([0, 1])
    with pytest.raises(ValueError):
        mixed.matrix


@pytest.mark.parametrize("compression", [None, CompressionSpec("topk", fraction=0.05)], ids=["dense", "topk"])
def test_group_state_payloads_match_reference(pair, compression):
    """Per-group model bits and uplink payloads (under top-k: the spec's bits
    on each group's flat row) equal the reference's; the engine's program
    keeps its own parameters, and a program no client trains raises."""
    ref, sc, _ = pair
    params = sc.program.init(torch.Generator().manual_seed(0))
    pack = FlatPack(params)
    gs = build_group_state(sc.clients, sc.program, params, pack, 0, compression)
    ref_params = ref.program.init(jax.random.PRNGKey(0))
    ref_comp = None if compression is None else RefCompressionSpec(**dataclasses.asdict(compression))
    want = ref_build_group_state(ref.clients, ref.program, ref_params, RefFlatPack(ref_params), 0, ref_comp)
    assert [p.name for p in gs.programs] == ["cnn", "mlp"] and gs.params[0] is params and gs.packs[0] is pack
    np.testing.assert_array_equal(gs.group_of, want.group_of)
    assert gs.bits == want.bits and gs.uplink_bits == want.uplink_bits
    assert gs.uplink_bits[0] != gs.uplink_bits[1]
    with pytest.raises(ValueError, match="matches none"):
        build_group_state(sc.clients, MLPProgram(feat=(187, 1), classes=5, hidden=7), params, pack, 0)


# -- the scenario ---------------------------------------------------------------------
def test_model_mix_scenario_matches_reference_builder():
    """Shards, test set, public pools (15 a edge: 3 of each class, drawn
    after the test set), ``model_bits`` (the larger architecture's) and name
    byte-equal to the JAX builder's."""
    sc = build_scenario("heartbeat", model_mix=MIX, device="cpu", **BUILD)
    want = ref_build_scenario("heartbeat", model_mix=MIX, **BUILD)
    assert sc.is_hetero and sc.name == want.name == "heartbeat-mix(cnn+mlp)"
    assert sc.model_bits == want.model_bits and sc.distill == DistillSpec()
    assert [c.program.name for c in sc.clients] == ["cnn"] * 12 + ["mlp"] * 6
    for a, b in zip(sc.clients, want.clients):
        np.testing.assert_array_equal(a.shard.x, b.shard.x)
        np.testing.assert_array_equal(a.shard.y, b.shard.y)
    np.testing.assert_array_equal(sc.test.x, want.test.x)
    assert len(sc.public) == len(want.public) == sc.n_edges
    for a, b in zip(sc.public, want.public):
        assert len(a) == 15
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.y, b.y)


ENGINES = {
    "reference": {},
    "sync-device": {"engine": "sync"},
    "sync-host": {"engine": "sync", "pipeline": "host"},
    "async": {"engine": "async"},
}


@pytest.mark.parametrize("engine", list(ENGINES))
def test_homogeneous_model_mix_bit_identical_to_model(engine):
    """A one-program mix is not a hetero population: no public pool, no
    fuse, and every engine's run bit-identical to ``model="cnn"``."""
    a = build_scenario("heartbeat", model="cnn", device="cpu", hparams=CAPPED, **BUILD)
    b = build_scenario("heartbeat", model_mix={"cnn": 18}, device="cpu", hparams=CAPPED, **BUILD)
    assert not b.is_hetero and b.public is None and b.distill is None and b.name == a.name
    lam = a.assign("eara-sca", device="cpu").lam
    ra, rb = (s.simulate(lam, 1, seed=3, device="cpu", **ENGINES[engine]) for s in (a, b))
    np.testing.assert_array_equal(flat(ra.final_params), flat(rb.final_params))
    assert [h.test_acc for h in ra.history] == [h.test_acc for h in rb.history]
    assert ra.accountant.totals() == rb.accountant.totals()


# -- the readable simulator and the engines --------------------------------------------
def test_hetero_simulator_matches_reference(pair):
    """``HeteroHFLSimulation`` against the reference's at ``HFLSchedule(1,
    1)``, 2 cloud rounds: accuracy 1e-6, parameters 5e-3, accountant totals
    and per-EU traffic exact; final parameters keyed by program."""
    ref, sc, lam = pair
    want = ref.simulate(lam, 2)
    got = sc.simulate(lam, 2, device="cpu")
    assert set(got.final_params) == {"cnn", "mlp"}
    check_run(want, got, loss_tol=5e-3)


@pytest.mark.parametrize("sched", [(1, 1), (2, 1)], ids=str)
@pytest.mark.parametrize("pipeline", ["device", "host"])
def test_sync_pipelines_match_port_simulator(pair, pipeline, sched):
    """Both sync pipelines against the port's own hetero simulator: accuracy
    1e-6, loss 5e-3, parameters 1e-3, traffic exact."""
    _, sc, lam = pair
    want = sc.simulate(lam, 2, schedule=HFLSchedule(*sched), device="cpu")
    got = sc.simulate(lam, 2, schedule=HFLSchedule(*sched), engine="sync", pipeline=pipeline, device="cpu")
    check_run(want, got, loss_tol=5e-3, param_tol=1e-3, flat_want=flat)


@pytest.mark.parametrize("engine", ["sync", "async"])
def test_engines_match_reference(pair, engine):
    """The port's sync device pipeline and async engine against the
    reference's on the same population, 2 cloud rounds: accuracy 1e-6,
    parameters 1e-3, accounting exact."""
    ref, sc, lam = pair
    kw = {"latency": ref.cost.latency} if engine == "async" else {}
    want = ref.simulate(lam, 2, engine=engine, **kw)
    got = sc.simulate(lam, 2, engine=engine, device="cpu")
    check_run(want, got, loss_tol=5e-3, param_tol=1e-3)
    assert got.wall_seconds == want.wall_seconds


def test_topk_group_payloads_match_reference(pair):
    """Under top-k each EU pays its own group's compressed uplink, equal to
    the reference's engine, per EU."""
    ref, sc, lam = pair
    spec = CompressionSpec("topk", fraction=0.05)
    want = ref.simulate(lam, 1, engine="sync", compression=spec)
    got = sc.simulate(lam, 1, engine="sync", compression=spec, device="cpu")
    check_run(want, got, loss_tol=5e-3, param_tol=1e-3)
    up = got.accountant.eu_bits_up
    assert up[0] != up[17] and up[0] == spec.bits(torch.zeros(pack_for(sc.clients[0].program).dim))


@pytest.fixture(scope="module")
def chaos_reference(pair):
    """The reference sync engine's run of a hetero population under the
    chaos spec, 2 cloud rounds, once for both pipelines' tests."""
    ref, _, lam = pair
    spec = FaultSpec(seed=3, **CHAOS)
    return spec, ref.simulate(lam, 2, engine="sync", faults=spec)


@pytest.mark.parametrize("pipeline", ["device", "host"])
def test_chaos_faults_match_reference(pair, chaos_reference, pipeline):
    """The chaos fault spec on a hetero population: both sync pipelines
    equal the reference's sync engine (accuracy 1e-6, parameters 1e-3,
    accounting exact) on its cost matrices; uploads are dropped."""
    ref, sc, lam = pair
    spec, want = chaos_reference
    with reference_costs(ref):
        got = sc.simulate(lam, 2, engine="sync", pipeline=pipeline, faults=spec, device="cpu")
    check_run(want, got, loss_tol=5e-3, param_tol=1e-3)
    assert got.accountant.totals()["dropped_uploads"] > 0


def test_engines_take_per_group_server_momentum(pair):
    """The engines accept what the reference's accept: a per-group server
    momentum (one velocity per group row), which ``Scenario.simulate``
    refuses for a hetero population."""
    _, sc, lam = pair
    kw = dict(public_shards=sc.public, distill=sc.distill, server_momentum=0.9, device="cpu")
    for eng in (BatchedSyncEngine(sc.clients, lam, sc.program, sc.test, **kw),
                AsyncHFLEngine(sc.clients, lam, sc.program, sc.test, latency=sc.cost.latency, **kw)):
        res = eng.run(2)
        assert set(res.final_params) == {"cnn", "mlp"} and np.isfinite(res.history[-1].mean_local_loss)
        assert len(eng._momentum) == 2 and all(m.velocity is not None for m in eng._momentum)


def test_hetero_final_params_suffixes_clashes():
    cnn = CNNProgram(MICRO_CNN)
    out = hetero_final_params([cnn, CNNProgram(CNNConfig(n_classes=3, seq_len=16)), MLPProgram()], ["a", "b", "c"])
    assert out == {"cnn": "a", "cnn#1": "b", "mlp": "c"}


# -- error paths ----------------------------------------------------------------------
BUILD_ERRORS = {
    "fedsgd": (dict(model_mix=MIX, fedsgd=True), ValueError),
    "model-and-mix": (dict(model="mlp", model_mix=MIX), ValueError),
    "cross-family": (dict(model_mix={"cnn": 17, "lm": 1}), ValueError),
    "unknown": (dict(model_mix={"cnn": 17, "nope": 1}), ValueError),
    "count-below-1": (dict(model_mix={"cnn": 18, "mlp": 0}), ValueError),
    "sum": (dict(model_mix={"cnn": 3, "mlp": 3}), ValueError),
    "lm-dataset": (dict(dataset="lm", model_mix=MIX), ValueError),
    "lazy": (dict(model_mix=MIX, lazy=True, n_eus=100), ValueError),
}


@pytest.mark.parametrize("case", list(BUILD_ERRORS))
def test_build_scenario_model_mix_errors(case):
    """Each bad ``model_mix`` raises the reference's exception type."""
    kw, exc = BUILD_ERRORS[case]
    kw = {"dataset": "heartbeat", "scale": 0.02, "n_test_per_class": 4, **kw}
    with pytest.raises(exc):
        build_scenario(device="cpu", **kw)
    with pytest.raises(exc):
        ref_build_scenario(**kw)


def test_sequence_model_mix_is_queued():
    """A mix of "lm" and "moe" (once queued as Queue 1 item 10b) builds the
    mixed token population: one public token pool per edge, the default
    ``DistillSpec``, the reference's name and pools
    (``tests/test_torch_moe.py`` runs it against the reference)."""
    sc = build_scenario("heartbeat", model_mix={"lm": 8, "moe": 4}, scale=0.05, n_test_per_class=4, device="cpu")
    assert sc.is_hetero and sc.name == "mix(lm+moe)" and sc.distill == DistillSpec()
    assert len(sc.public) == sc.n_edges == 4
    assert [c.program.name for c in sc.clients] == ["lm"] * 8 + ["moe"] * 4
    for pool in sc.public:
        assert pool.x.shape == (16, 32) and pool.x.dtype == np.int32 and np.bincount(pool.y).tolist() == [4] * 4


SIM_ERRORS = {
    "cohort": (dict(cohort=object()), ValueError),
    "server-momentum": (dict(server_momentum=0.9), ValueError),
    "divergence": (dict(track_divergence=True), ValueError),
    "divergence-sync": (dict(track_divergence=True, engine="sync"), ValueError),
    "wall-clock": (dict(wall_clock=True), ValueError),
    "faults": (dict(faults=FaultSpec(seed=1)), ValueError),
    "serve": (dict(serve=TrafficSpec(queries=8, batch=8)), ValueError),
    "telemetry": (dict(telemetry=True, server_momentum=0.9), ValueError),
}


@pytest.mark.parametrize("case", list(SIM_ERRORS))
def test_simulate_hetero_errors(pair, case):
    """What the reference refuses for a hetero population raises
    ``ValueError`` (with ``telemetry=`` on too, as in the reference),
    serving traffic included: a hetero population has no one global model
    to serve."""
    _, sc, lam = pair
    kw, exc = SIM_ERRORS[case]
    with pytest.raises(exc):
        sc.simulate(lam, 1, device="cpu", **kw)


@pytest.mark.parametrize("public", ["missing", "empty"])
@pytest.mark.parametrize("engine", ["reference", "sync", "async"])
def test_fuse_needs_public_shards(pair, engine, public):
    _, sc, lam = pair
    shards = None if public == "missing" else sc.public[:-1] + [Dataset(sc.public[0].x[:0], sc.public[0].y[:0], 5)]
    kw = dict(distill=DistillSpec(), device="cpu")
    with pytest.raises(ValueError, match="public shard"):
        if engine == "reference":
            HeteroHFLSimulation(sc.clients, lam, sc.test, public=shards, **kw)
        elif engine == "sync":
            BatchedSyncEngine(sc.clients, lam, sc.program, sc.test, public_shards=shards, **kw)
        else:
            AsyncHFLEngine(sc.clients, lam, sc.program, sc.test, latency=sc.cost.latency, public_shards=shards, **kw)


def test_simulate_distill_override_and_no_fuse(pair):
    """``simulate(distill=)`` overrides the scenario's spec (another run),
    and a hetero simulator without a spec runs its groups apart."""
    _, sc, lam = pair
    base = sc.simulate(lam, 1, engine="sync", device="cpu")
    other = sc.simulate(lam, 1, engine="sync", distill=DistillSpec(steps=2, lr=5e-2), device="cpu")
    assert not np.array_equal(flat(base.final_params), flat(other.final_params))
    apart = HeteroHFLSimulation(sc.clients, lam, sc.test, device="cpu")
    assert apart.distill is None and np.isfinite(apart.run(1).history[0].mean_local_loss)


def test_reference_flat_rows_of_hetero_params_agree():
    """``flat`` / ``ref_flat`` lay a program-keyed dict out alike (sorted
    keys), which the hetero parity checks rely on."""
    cnn, mlp = _micro_programs()
    trees = {"cnn": reference_program(cnn).init(jax.random.PRNGKey(0)),
             "mlp": reference_program(mlp).init(jax.random.PRNGKey(0))}
    port = params_from_numpy(jax.tree.map(np.asarray, trees))
    np.testing.assert_array_equal(flat(port), ref_flat(trees))
