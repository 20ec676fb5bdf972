"""The dense transformer LM on the token-stream population, against the JAX
package's.

``build_scenario("lm")`` must give the reference's shards, test set and
topic counts byte for byte; ``lm_loss`` and ``chunked_lm_loss`` agree with
the reference's to 1e-6; ``LMProgram`` federates on the readable
simulator, both sync pipelines, async and the lazy streaming engine and is
held by ``check_run`` (accuracy 1e-6, loss 1e-5, parameters 5e-3, traffic
exact) from the reference's initial parameters; serving under traffic
scores next-token accuracy.  "mamba" and "rwkv" build their populations
as the reference's (their programs are ``tests/test_torch_recurrent.py``'s,
the MoE program ``tests/test_torch_moe.py``'s); a vlm config serves as the
dense stack it is.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.federated.sampling as ref_sampling  # noqa: E402
import repro.training.loss as ref_loss  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.core.hfl import HFLSchedule as RefSchedule  # noqa: E402
from repro.federated import build_scenario as ref_build  # noqa: E402
from repro.federated.programs import tiny_lm_config as ref_tiny_lm_config  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402
from repro.serving import ServeEngine as RefServeEngine  # noqa: E402
from repro.serving.traffic import ServeTraffic as RefServeTraffic  # noqa: E402
from repro.serving.traffic import TrafficSpec as RefTrafficSpec  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import HFLSchedule  # noqa: E402
from repro_torch.federated import PROGRAMS, CohortSpec, LMProgram, build_scenario, tiny_lm_config  # noqa: E402
from repro_torch.serving import Request, ServeEngine, TrafficSpec  # noqa: E402
from repro_torch.training import loss  # noqa: E402
from torch_parity import ReferencePopulation, check_run, flat, reference_inits, reference_program  # noqa: E402

# a small cut of the population: 6 EUs over 2 edges, ~40 sequences each,
# local epochs capped at 4 steps, 8 test sequences a topic
SMALL = dict(lm_eus=6, lm_edges=2, scale=0.1, n_test_per_class=8, seed=0)
CAPPED = [{"max_steps": 4}] * 6
SERVE = dict(queries=24, batch=8, seed=1)
ENGINES = {
    "reference": ("reference", {}),
    "sync-device": ("sync", {"pipeline": "device"}),
    "sync-host": ("sync", {"pipeline": "host"}),
    "async": ("async", {}),
}
LAZY = dict(lazy=True, n_eus=60, n_edges=3, seed=2, n_test_per_class=16)


def _datasets_equal(a, b):
    assert a.x.dtype == b.x.dtype and a.y.dtype == b.y.dtype and a.n_classes == b.n_classes
    assert a.x.tobytes() == b.x.tobytes() and a.y.tobytes() == b.y.tobytes()


@pytest.mark.parametrize(
    "kw", [{}, dict(lm_eus=7, lm_edges=3, lm_topics=3, lm_seq_len=16, lm_vocab=64, scale=0.2, seed=5)],
    ids=["defaults", "knobs"],
)
def test_lm_scenario_byte_equal_to_reference(kw):
    """Shards, test set and topic counts byte-equal to the reference's at
    the same arguments, under ``build_scenario("lm")`` and
    ``build_scenario(model="lm")``; a ``model_mix`` of "lm" alone is the
    homogeneous population."""
    kw = dict(dict(n_test_per_class=10), **kw)
    ref = ref_build("lm", **kw)
    for sc in (build_scenario("lm", device="cpu", **kw), build_scenario(model="lm", device="cpu", **kw)):
        assert sc.name == ref.name == "lm" and not sc.is_hetero
        assert sc.class_counts.tobytes() == np.asarray(ref.class_counts).tobytes()
        assert len(sc.clients) == len(ref.clients) and sc.n_edges == ref.n_edges
        for c, rc in zip(sc.clients, ref.clients):
            _datasets_equal(c.shard, rc.shard)
        _datasets_equal(sc.test, ref.test)
        assert sc.program == LMProgram(
            cfg=tiny_lm_config(vocab_size=ref.program.cfg.vocab_size, seq_len=ref.program.seq_len),
            seq_len=ref.program.seq_len, n_topics=ref.program.n_topics,
        )
        assert sc.model_bits == ref.model_bits
        assert sc.init_edge.tolist() == np.asarray(sc.topo.dist).argmin(axis=1).tolist()
    mix = build_scenario("lm", model_mix={"lm": kw.get("lm_eus", 12)}, device="cpu", **kw)
    assert mix.program == sc.program and not mix.is_hetero and mix.name == "lm"


def test_tiny_lm_config_and_registry_match_reference():
    """``tiny_lm_config``'s defaults and the "lm" factory build the
    reference's configuration: vocab 128, seq 32, d 32, 2 layers, 2 heads,
    d_ff 64, gelu, tied, fp32, plain attention."""
    assert dataclasses.asdict(tiny_lm_config()) == dataclasses.asdict(ref_tiny_lm_config())
    assert dataclasses.asdict(tiny_lm_config(vocab_size=64, d_model=16)) == dataclasses.asdict(
        ref_tiny_lm_config(vocab_size=64, d_model=16)
    )
    prog = PROGRAMS.get("lm")(vocab_size=64, seq_len=16, n_topics=3)
    ref = reference_program(prog)
    assert (prog.name, prog.feat_shape, prog.n_classes) == (ref.name, ref.feat_shape, ref.n_classes)
    assert prog.feat_dtype == ref.feat_dtype and not prog.cfg.use_flash
    assert PROGRAMS.get("fedsgd")(base="lm").name == "fedsgd-lm"


@pytest.mark.parametrize("shift", [True, False])
def test_lm_loss_matches_reference(shift):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 9, 40)) * 3).astype(np.float32)
    tokens = rng.integers(0, 40, (3, 9)).astype(np.int32)
    want = float(ref_loss.lm_loss(jnp.asarray(logits), jnp.asarray(tokens), shift=shift))
    got = float(loss.lm_loss(torch.as_tensor(logits), torch.as_tensor(tokens), shift=shift))
    assert got == pytest.approx(want, abs=1e-6)


@pytest.mark.parametrize("chunk", [4, 8, 16, 512])
def test_chunked_lm_loss_matches_reference(chunk):
    """The chunked loss at every chunk size equals the reference's and the
    unchunked loss of the same logits; a chunk that does not divide the
    sequence raises."""
    rng = np.random.default_rng(1)
    hidden = rng.standard_normal((2, 16, 24)).astype(np.float32)
    emb = (rng.standard_normal((50, 24)) * 0.3).astype(np.float32)
    labels = rng.integers(0, 50, (2, 16)).astype(np.int32)
    want = float(ref_loss.chunked_lm_loss(jnp.asarray(hidden), jnp.asarray(emb), jnp.asarray(labels), chunk=chunk))
    h, e, y = torch.as_tensor(hidden), torch.as_tensor(emb), torch.as_tensor(labels)
    got = float(loss.chunked_lm_loss(h, e, y, chunk=chunk))
    assert got == pytest.approx(want, abs=1e-6)
    assert got == pytest.approx(float(loss.lm_loss(h @ e.T, y, shift=False)), abs=1e-6)
    with pytest.raises(ValueError, match="multiple"):
        loss.chunked_lm_loss(h, e, y, chunk=5)


def test_lm_program_matches_reference():
    """Forward, loss, metric and the vmapped cohort loss of the port's
    ``LMProgram`` on the reference's parameters, to 1e-5; the loss's
    gradient through ``torch.func.vmap`` equals each client's own."""
    prog = PROGRAMS.get("lm")()
    ref = reference_program(prog)
    jp = ref.init(jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(2).integers(0, 128, (4, 32)).astype(np.int32)
    y = np.zeros(4, np.int32)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    np.testing.assert_allclose(prog.apply(tp, xt).numpy(), np.asarray(ref.apply(jp, jnp.asarray(x))), atol=1e-5)
    assert float(prog.loss(tp, xt, yt)) == pytest.approx(float(ref.loss(jp, jnp.asarray(x), jnp.asarray(y))), abs=1e-5)
    assert float(prog.metric(tp, xt, yt)) == pytest.approx(float(ref.metric(jp, jnp.asarray(x), jnp.asarray(y))),
                                                           abs=1e-6)
    stacked = jax.tree.map(lambda a: torch.stack([a, a * 0.5]), tp)
    xs = torch.stack([xt, xt.flip(0)])
    cohort = prog.cohort_loss(stacked, xs, torch.stack([yt, yt]))
    for c in range(2):
        one = jax.tree.map(lambda a: a[c], stacked)
        assert float(cohort[c]) == pytest.approx(float(prog.loss(one, xs[c], yt)), abs=1e-6)


def test_lm_cohort_cost_counts_each_client():
    """``jit_cost`` counts the mapped LM cohort at one client and scales by
    C: at C 3 its FLOPs are 3x one client's, equal to the reference's HLO
    count of the same epoch."""
    from repro.engine import cohort as ref_cohort
    from repro.engine.flatten import FlatPack as RefFlatPack
    from repro.telemetry import Telemetry as RefTelemetry
    from repro_torch.engine import FlatPack
    from repro_torch.engine.cohort import _cohort_epoch_flat
    from repro_torch.telemetry import Telemetry

    prog = PROGRAMS.get("lm")()
    ref = reference_program(prog)
    pk, rpk = FlatPack(prog.init(torch.Generator().manual_seed(0))), RefFlatPack(ref.init(jax.random.PRNGKey(0)))

    def port(c):
        return Telemetry().jit_cost("e", _cohort_epoch_flat, torch.zeros((c, pk.dim)),
                                    torch.zeros((c, 2, 4, 32), dtype=torch.int32),
                                    torch.zeros((c, 2, 4), dtype=torch.int32), pk.spec, prog, 2, 1e-3)

    three = port(3)
    assert three["flops"] == 3 * port(1)["flops"] > 0
    want = RefTelemetry().jit_cost("e", ref_cohort._cohort_epoch_flat, jnp.zeros((3, rpk.dim)),
                                   jnp.zeros((3, 2, 4, 32), jnp.int32), jnp.zeros((3, 2, 4), jnp.int32), rpk.spec,
                                   ref, 2, 1e-3)
    assert three["flops"] == want["flops"]


# -- the federated LM on every engine -----------------------------------------
@pytest.fixture(scope="module")
def pair():
    """The small LM population in both packages (the port with the
    reference's cost model) and its EARA-SCA assignment; the port's engines
    start from the reference's initial parameters."""
    with reference_inits():
        sc = build_scenario("lm", hparams=CAPPED, device="cpu", **SMALL)
        ref = ReferencePopulation(sc)
        sc = dataclasses.replace(sc, cost=ref.cost)
        yield ref, sc, sc.assign("eara-sca", device="cpu").lam


@pytest.fixture(scope="module")
def runs(pair):
    """Two cloud rounds of each engine in both packages, serving next-token
    traffic."""
    ref, sc, lam = pair
    out = {}
    for engine, (name, kw) in ENGINES.items():
        rkw = dict(kw, latency=ref.cost.latency) if name == "async" else dict(kw)
        serve = RefServeTraffic(RefTrafficSpec(**SERVE), ref.clients, ref.program)
        want = ref.simulate(lam, 2, engine=name, serve=serve, **rkw)
        got = sc.simulate(lam, 2, engine=name, serve=TrafficSpec(**SERVE), device="cpu", **kw)
        out[engine] = want, got
    return out


@pytest.mark.parametrize("engine", list(ENGINES))
def test_lm_engines_match_reference(runs, engine):
    """Per-round next-token accuracy 1e-6, loss 1e-5, parameters 5e-3,
    accountant totals and per-EU traffic exact."""
    want, got = runs[engine]
    check_run(want, got)
    assert flat(got.final_params).shape == (20_640,)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_lm_serve_matches_reference(runs, engine):
    """Serving the LM scores next-token accuracy: the records against the
    reference's, queries and staleness exact, ``serve_acc`` within 1e-6."""
    want, got = runs[engine]
    for rw, rg in zip(want.serve_history, got.serve_history, strict=True):
        assert (rg["round"], rg["queries"], rg["serve_staleness_rounds"]) == (
            rw["round"], rw["queries"], rw["serve_staleness_rounds"]
        )
        assert rg["serve_acc"] == pytest.approx(rw["serve_acc"], abs=1e-6)


def test_lm_serve_on_equals_off(pair, runs):
    """The device pipeline with serving off gives the serving run's
    parameters and history bit for bit."""
    _, sc, lam = pair
    on = runs["sync-device"][1]
    off = sc.simulate(lam, 2, engine="sync", device="cpu")
    np.testing.assert_array_equal(flat(on.final_params), flat(off.final_params))
    assert [(m.test_acc, m.mean_local_loss) for m in on.history] == [
        (m.test_acc, m.mean_local_loss) for m in off.history
    ]


def test_lm_fedsgd_matches_reference(pair):
    """FedSGD over the LM (one plain-SGD step, fp16 gradient uplink) on the
    device pipeline against the reference's."""
    ref, sc, lam = pair
    with reference_inits():
        sgd = build_scenario("lm", hparams=CAPPED, fedsgd=True, grad_bits=16, device="cpu", **SMALL)
        rsgd = ReferencePopulation(sgd)
        sgd = dataclasses.replace(sgd, cost=ref.cost)
        check_run(rsgd.simulate(lam, 2, engine="sync"), sgd.simulate(lam, 2, engine="sync", device="cpu"))


# -- the lazy token population -------------------------------------------------
def test_lazy_lm_matches_reference_stream():
    """``build_scenario("lm", lazy=True)``: the same source, test set and
    assignment as the reference's, and the streaming engine's run against
    the reference's on it (accuracy 1e-6, parameters 1e-4 as the streaming
    parity holds the CNN, traffic exact)."""
    ref = ref_build("lm", **LAZY)
    sc = build_scenario("lm", device="cpu", **LAZY)
    assert sc.name == ref.name == "lm-stream-lm"
    _datasets_equal(sc.test, ref.test)
    assert sc.edge_of.tobytes() == ref.edge_of.tobytes()
    for cid in (0, 17, 59):
        _datasets_equal(sc.source.shard(cid), ref.source.shard(cid))
    assert sc.model_bits == ref.model_bits
    spec = dict(size=12, seed=4)
    with reference_inits():
        got = sc.simulate(CohortSpec(**spec), cloud_rounds=2, schedule=HFLSchedule(1, 1), seed=0, device="cpu")
    want = ref.simulate(ref_sampling.CohortSpec(**spec), cloud_rounds=2, schedule=RefSchedule(1, 1), seed=0)
    check_run(want, got, param_tol=1e-4)


# -- the recurrent programs' populations, and the vlm stack --------------------
@pytest.mark.parametrize("name,item", [("mamba", "10c"), ("rwkv", "10c")])
def test_unported_sequence_programs_raise(name, item):
    """"mamba" and "rwkv" (ported by Queue 1 item ``item``) build as the
    reference's, as ``model=``, in a ``model_mix`` beside "lm" (hetero, one
    public token pool per edge, byte-equal) and in the lazy population;
    their training runs are ``tests/test_torch_recurrent.py``'s."""
    assert item == "10c"
    kw = dict(scale=0.1, n_test_per_class=8)
    ref, sc = ref_build(model=name, **kw), build_scenario(model=name, device="cpu", **kw)
    assert sc.name == ref.name == name and sc.model_bits == ref.model_bits
    assert sc.class_counts.tobytes() == np.asarray(ref.class_counts).tobytes()
    mix = {"lm": 6, name: 6}
    ref, sc = ref_build("lm", model_mix=mix, **kw), build_scenario("lm", model_mix=mix, device="cpu", **kw)
    assert sc.is_hetero and sc.name == ref.name == f"mix(lm+{name})" and sc.model_bits == ref.model_bits
    assert [c.program.name for c in sc.clients] == [c.program.name for c in ref.clients]
    for a, b in zip(sc.public, ref.public, strict=True):
        _datasets_equal(a, b)
    lazy = dict(lazy=True, n_eus=20, model=name)
    ref, sc = ref_build("lm", **lazy), build_scenario("lm", device="cpu", **lazy)
    assert sc.name == ref.name == f"lm-stream-{name}" and sc.program == PROGRAMS.get(name)()
    assert sc.edge_of.tobytes() == ref.edge_of.tobytes()


def test_vlm_smoke_serves_as_the_reference():
    """``chameleon-34b`` smoke (family "vlm") runs as the dense stack it is:
    greedy tokens identical to the reference's ``ServeEngine`` on the same
    parameters and prompts."""
    rcfg, cfg = ref_smoke("chameleon-34b"), get_smoke_config("chameleon-34b")
    jp = ref_init_params(jax.random.PRNGKey(0), rcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (7, 7, 4)]
    ref = RefServeEngine(rcfg, params=jp, max_seq=24).run([RefRequest(p.copy(), max_new_tokens=5) for p in prompts])
    out = ServeEngine(cfg, params=tp, max_seq=24, device="cpu").run([Request(p.copy(), max_new_tokens=5)
                                                                     for p in prompts])
    for a, b in zip(out, ref, strict=True):
        np.testing.assert_array_equal(a.out, b.out)


def test_train_cli_lm(capsys):
    """``--dataset lm`` federates the LM from the launcher, as the
    reference's."""
    from repro_torch.launch import train

    train.main(["--paper", "--dataset", "lm", "--rounds", "1", "--scale", "0.05", "--serve", "8",
                "--serve-batch", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "round 1: acc=" in out and "serve_acc=" in out
