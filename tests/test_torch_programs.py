"""The MLP and FedSGD programs and the ``PROGRAMS`` registry: the port
against the JAX package on the same inputs, on every engine."""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.federated.programs import PROGRAMS as REF_PROGRAMS  # noqa: E402
from repro.federated.programs import FedSGDProgram as RefFedSGDProgram  # noqa: E402
from repro.federated.programs import MLPProgram as RefMLPProgram  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.engine.flatten import FlatPack  # noqa: E402
from repro_torch.federated import PROGRAMS, CNNProgram, FedSGDProgram, MLPProgram, build_scenario  # noqa: E402
from repro.utils.tree import tree_size_bytes as ref_tree_size_bytes  # noqa: E402
from torch_parity import ReferencePopulation, check_run, flat, ref_flat, reference_inits, reference_program  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
KW = dict(scale=0.02, seed=0, n_test_per_class=20)
ENGINES = {"reference": ("reference", "device"), "sync-host": ("sync", "host"), "sync-device": ("sync", "device")}


@pytest.mark.parametrize("module", ["utils/registry.py", "data/synthetic_health.py"])
def test_copied_modules_are_byte_equal(module):
    """Modules the port copies rather than ports stay byte-equal to the
    reference's."""
    assert (ROOT / "src/repro_torch" / module).read_bytes() == (ROOT / "src/repro" / module).read_bytes()


def _mlp_inputs(feat, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((7,) + feat).astype(np.float32)
    y = rng.integers(0, 5, 7).astype(np.int32)
    return x, y


@pytest.mark.parametrize("feat,hidden", [((187, 1), 64)])
def test_mlp_apply_and_loss_match_reference(feat, hidden):
    """``MLPProgram.apply``/``loss``/``metric`` on the reference's
    parameters within 1e-5 (GeLU in its tanh form, as ``jax.nn.gelu``),
    the loss gradient within 1e-5, and the cohort form equal to the
    per-client forward."""
    ref = RefMLPProgram(feat=feat, classes=5, hidden=hidden)
    prog = MLPProgram(feat=feat, classes=5, hidden=hidden)
    jp = ref.init(jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    x, y = _mlp_inputs(feat)
    np.testing.assert_allclose(
        prog.apply(tp, torch.tensor(x)).numpy(), np.asarray(ref.apply(jp, jnp.asarray(x))), atol=1e-5, rtol=1e-5
    )
    loss = prog.loss(tp, torch.tensor(x), torch.tensor(y))
    want, grads = jax.value_and_grad(ref.loss)(jp, jnp.asarray(x), jnp.asarray(y))
    assert float(loss) == pytest.approx(float(want), abs=1e-5)
    assert float(prog.metric(tp, torch.tensor(x), torch.tensor(y))) == float(ref.metric(jp, jnp.asarray(x), jnp.asarray(y)))
    row = FlatPack(tp).ravel(tp).requires_grad_(True)
    (g,) = torch.autograd.grad(prog.loss(FlatPack(tp).unravel(row), torch.tensor(x), torch.tensor(y)), row)
    np.testing.assert_allclose(g.numpy(), ref_flat(grads), atol=1e-5, rtol=1e-5)
    stacked = {k: {kk: torch.stack([v, 2 * v]) for kk, v in d.items()} for k, d in tp.items()}
    xs = torch.stack([torch.tensor(x), torch.flip(torch.tensor(x), [0])])
    cohort = prog.apply_cohort(stacked, xs)
    twice = {k: {kk: 2 * v for kk, v in d.items()} for k, d in tp.items()}
    np.testing.assert_allclose(cohort[0].numpy(), prog.apply(tp, xs[0]).numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(cohort[1].numpy(), prog.apply(twice, xs[1]).numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", ["gemm", "xla"])
@pytest.mark.parametrize("program", [CNNProgram(), MLPProgram()], ids=["cnn", "mlp"])
def test_cohort_loss_forms_agree(program, impl):
    """``cohort_loss`` in either form is each client's own ``loss``."""
    gen = torch.Generator().manual_seed(0)
    trees = [program.init(gen) for _ in range(3)]
    pack = FlatPack(trees[0])
    stacked = pack.unravel_batched(pack.stack(trees))
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((3, 6) + program.feat_shape).astype(np.float32))
    y = torch.tensor(rng.integers(0, program.n_classes, (3, 6)))
    got = program.cohort_loss(stacked, x, y, impl=impl)
    want = torch.stack([program.loss(t, x[c], y[c]) for c, t in enumerate(trees)])
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("grad_bits", [16, 32])
def test_fedsgd_quantize_upload_matches_reference(grad_bits):
    """The fp16 round trip of the update delta, leaf by leaf on trees and
    on (C, D) flat rows, bit for bit; exact at 32 bits."""
    rng = np.random.default_rng(2)
    start = {"a": rng.standard_normal((4, 5)).astype(np.float32), "b": rng.standard_normal(3).astype(np.float32)}
    trained = {k: v + 1e-3 * rng.standard_normal(v.shape).astype(np.float32) for k, v in start.items()}
    ref, prog = RefFedSGDProgram(grad_bits=grad_bits), FedSGDProgram(grad_bits=grad_bits)
    want = ref.quantize_upload(jax.tree.map(jnp.asarray, start), jax.tree.map(jnp.asarray, trained))
    got = prog.quantize_upload(params_from_numpy(start), params_from_numpy(trained))
    np.testing.assert_array_equal(flat(got), ref_flat(want))
    rows = np.stack([ref_flat(start), ref_flat(trained)])
    want_rows = ref.quantize_upload(jnp.asarray(rows[:1]), jnp.asarray(rows[1:]))
    got_rows = prog.quantize_upload(torch.tensor(rows[:1]), torch.tensor(rows[1:]))
    np.testing.assert_array_equal(got_rows.numpy(), np.asarray(want_rows))
    assert prog.quantizes_upload == (grad_bits == 16) == ref.quantizes_upload
    assert prog.uplink_bits(3200.0) == ref.uplink_bits(3200.0)


def test_program_registry_matches_reference():
    """``PROGRAMS`` carries every name of the reference's registry ("cnn",
    "mlp", "lm", "moe", "mamba", "rwkv" and "fedsgd"), whose factories
    build the same configurations as the reference's; an unknown name
    raises as the reference's."""
    assert list(PROGRAMS.names()) == ["cnn", "fedsgd", "lm", "mamba", "mlp", "moe", "rwkv"]
    assert set(PROGRAMS.names()) == set(REF_PROGRAMS.names())
    mlp, ref_mlp = PROGRAMS.get("mlp")(hidden=32), REF_PROGRAMS.get("mlp")(hidden=32)
    assert (mlp.feat, mlp.classes, mlp.hidden, mlp.name) == (ref_mlp.feat, ref_mlp.classes, ref_mlp.hidden, ref_mlp.name)
    sgd, ref_sgd = PROGRAMS.get("fedsgd")(base="mlp", grad_bits=16), REF_PROGRAMS.get("fedsgd")(base="mlp", grad_bits=16)
    assert (sgd.name, sgd.grad_bits, sgd.single_step) == (ref_sgd.name, ref_sgd.grad_bits, ref_sgd.single_step)
    assert PROGRAMS.get("cnn")() == CNNProgram()
    with pytest.raises(ValueError, match="grad_bits"):
        FedSGDProgram(grad_bits=8)
    with pytest.raises(TypeError):
        FedSGDProgram(base=FedSGDProgram())
    moe, ref_moe = PROGRAMS.get("moe")(n_experts=8, z_weight=0.0), REF_PROGRAMS.get("moe")(n_experts=8, z_weight=0.0)
    assert reference_program(moe) == ref_moe and moe.name == ref_moe.name == "moe"
    assert dataclasses.asdict(moe.cfg) == dataclasses.asdict(ref_moe.cfg)
    for name in ("mamba", "rwkv"):
        prog, ref_prog = PROGRAMS.get(name)(d_ff=48), REF_PROGRAMS.get(name)(d_ff=48)
        assert reference_program(prog) == ref_prog and prog.name == ref_prog.name == name
        assert dataclasses.asdict(prog.cfg) == dataclasses.asdict(ref_prog.cfg)
    with pytest.raises(KeyError, match="available"):
        PROGRAMS.get("s4")
    with pytest.raises(KeyError, match="available"):
        REF_PROGRAMS.get("s4")


@pytest.fixture(scope="module")
def workloads():
    """Port scenarios of each workload and the same populations in the
    reference package, the port's programs starting from the reference's
    parameters.  The scenario is named and its model sized as the
    reference's ``build_scenario`` names and sizes it."""
    out = {}
    for name, kw in (("mlp", dict(model="mlp")), ("fedsgd-16", dict(fedsgd=True, grad_bits=16)),
                     ("fedsgd-32", dict(fedsgd=True, grad_bits=32))):
        sc = build_scenario("heartbeat", device="cpu", **KW, **kw)
        ref = ReferencePopulation(sc)
        assert sc.name == f"heartbeat-{ref.program.name}"
        assert sc.model_bits == ref_tree_size_bytes(ref.program.init(jax.random.PRNGKey(0))) * 8
        out[name] = (ref, sc, sc.assign("eara-sca", device="cpu").lam)
    with reference_inits():
        yield out


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("workload", ["fedsgd-16", "fedsgd-32"])
def test_fedsgd_matches_reference_on_every_engine(workloads, workload, engine):
    """``build_scenario(fedsgd=True, grad_bits=16 | 32)`` on each engine
    against the reference's same engine: accuracy 1e-6, mean loss 1e-5,
    parameters 5e-3, and the uplink counted as the reference counts it (at
    16 bits, half the model per upload)."""
    ref, sc, lam = workloads[workload]
    name, pipeline = ENGINES[engine]
    want = ref.simulate(lam, 2, engine=name, pipeline=pipeline, seed=1, upp=0.8)
    got = sc.simulate(lam, cloud_rounds=2, seed=1, upp=0.8, engine=name, pipeline=pipeline, device="cpu")
    check_run(want, got)
    totals = got.accountant.totals()
    assert totals["eu_up_bits"] / totals["eu_down_bits"] == pytest.approx(0.5 if workload == "fedsgd-16" else 1.0)


@pytest.fixture(scope="module")
def mlp_run(workloads):
    ref, sc, lam = workloads["mlp"]
    return sc.simulate(lam, cloud_rounds=2, seed=1, upp=0.8, device="cpu")


def test_mlp_matches_reference(workloads, mlp_run):
    """``build_scenario(model="mlp")`` on the readable simulator against the
    reference's: accuracy 1e-6, mean loss 1e-5, parameters 5e-3."""
    ref, sc, lam = workloads["mlp"]
    check_run(ref.simulate(lam, 2, seed=1, upp=0.8), mlp_run)


@pytest.mark.parametrize("pipeline", ["host", "device"])
def test_mlp_engines_match_readable_simulator(workloads, mlp_run, pipeline):
    """The MLP on both sync pipelines against the port's own simulator:
    accuracy 1e-6, parameters 5e-3."""
    _, sc, lam = workloads["mlp"]
    got = sc.simulate(lam, cloud_rounds=2, seed=1, upp=0.8, engine="sync", pipeline=pipeline, device="cpu")
    check_run(mlp_run, got, loss_tol=5e-3, flat_want=flat)
