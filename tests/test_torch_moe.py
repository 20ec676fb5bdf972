"""The MoE family against the JAX package's on the same numpy inputs and
parameters: the router (``router_topk``) and the three dispatches of
``models/moe.py``, the MoE branches of the transformer (training forward
with its router losses, prefill and decode with the ``topk_gating``
kernel's combine weights), ``MoEProgram``, the MoE token population on
every engine, the ``{"lm", "moe"}`` mix, and ``ServeEngine`` on both MoE
smoke configs.

Tolerances: the router's combine, aux and z 1e-6; the layers 1e-5 in fp32
and 2e-2 in bf16 (the reference's kernel tolerances); the engines as
``check_run`` holds the LM (accuracy 1e-6, loss 1e-5, parameters 5e-3,
traffic exact); served tokens exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.models.moe as ref_moe  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.federated import build_scenario as ref_build  # noqa: E402
from repro.federated.programs import PROGRAMS as REF_PROGRAMS  # noqa: E402
from repro.federated.programs import tiny_moe_config as ref_tiny_moe_config  # noqa: E402
from repro.models import forward as ref_forward  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.models.transformer import decode_step as ref_decode_step  # noqa: E402
from repro.models.transformer import prefill as ref_prefill  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402
from repro.serving import ServeEngine as RefServeEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.federated import PROGRAMS, MoEProgram, build_scenario, tiny_moe_config  # noqa: E402
from repro_torch.kernels import topk_gating_ref  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.transformer import decode_step, forward, forward_hidden, prefill  # noqa: E402
from repro_torch.serving import Request, ServeEngine  # noqa: E402
from repro_torch.training.loss import lm_loss  # noqa: E402
from torch_parity import ReferencePopulation, check_run, flat, reference_inits, reference_program  # noqa: E402

ARCHS = ["granite-moe-3b-a800m", "dbrx-132b"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# the token population of tests/test_programs.py's sequence-model runs,
# local epochs capped at 4 steps (few cohort shapes for the reference)
POP = dict(scale=0.04, seed=0, n_test_per_class=6, lm_eus=5, lm_edges=2, lm_topics=3, lm_seq_len=16, lm_vocab=64)
CAPPED = [{"max_steps": 4}] * 5
# tests/test_distill.py's sequence model mix
MIX = {"lm": 4, "moe": 2}
MIX_POP = dict(lm_eus=6, lm_edges=2, scale=0.05, seed=0, n_test_per_class=8, lm_seq_len=16, lm_vocab=64,
               hparams=[{"max_steps": 4}] * 6)


def _np(t):
    return t.detach().float().numpy()


def _router_logits(t, e, seed=0):
    """Router logits with a tie row (three equal maxima) and an underflowed
    row (every probability but one is 0 in fp32)."""
    x = (np.random.default_rng(seed).standard_normal((t, e)) * 2).astype(np.float32)
    x[1, [e - 1, e // 2, 1]] = 5.0
    x[2] = -200.0
    x[2, 3] = 300.0
    x[3] = 0.0
    return x


def _layer_pair(arch, dtype="float32", seed=0):
    """(reference cfg, port cfg, reference MoE params, port MoE params)."""
    rcfg = dataclasses.replace(ref_smoke(arch), dtype=dtype)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    jp = ref_moe.moe_init(jax.random.PRNGKey(seed), rcfg)
    return rcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.fixture
def ref_dots(monkeypatch):
    """Lets the reference's bf16 layers run here.  XLA's CPU runtime has no
    bf16 x bf16 -> fp32 dot (``preferred_element_type=f32`` on bf16
    operands raises "Unsupported element type for DotThunk"); the patch
    gives such an einsum its operands upcast to fp32, the same exact
    products accumulated in fp32.  Nothing else of the reference changes."""
    einsum = jnp.einsum

    def einsum_f32(eq, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            ops = [o.astype(jnp.float32) for o in ops]
        return einsum(eq, *ops, preferred_element_type=preferred_element_type, **kw)

    monkeypatch.setattr(jnp, "einsum", einsum_f32)


def _hidden(shape, dtype, seed=1, scale=0.5):
    x = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    return jx, params_from_numpy(np.asarray(jx))


# -- the router ------------------------------------------------------------------
@pytest.mark.parametrize("e,k", [(4, 2), (16, 4), (40, 8)])
def test_router_topk_matches_reference(e, k):
    """Combine weights, aux and z loss at 1e-6, ties and underflow included."""
    x = _router_logits(12, e)
    cw, aw, zw = ref_moe.router_topk(jnp.asarray(x), k)
    cg, ag, zg = moe.router_topk(torch.as_tensor(x), k)
    np.testing.assert_allclose(cg.numpy(), np.asarray(cw), atol=1e-6, rtol=0)
    assert float(ag) == pytest.approx(float(aw), abs=1e-6, rel=1e-6)
    assert float(zg) == pytest.approx(float(zw), abs=1e-6, rel=1e-6)
    assert cg.dtype == torch.float32


def test_topk_gating_plain_equals_router_combine():
    """``topk_gating``'s plain version (what the serving functions launch on
    the card) equals ``router_topk``'s combine at the granite-moe router
    width (E 40, k 8), ties and an underflowed row (where the kernel picks
    fewer than k) included: the condition under which serving may take it."""
    x = torch.as_tensor(_router_logits(64, 40, seed=3))
    got = topk_gating_ref(x, 8)
    want, _, _ = moe.router_topk(x, 8)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    ref, _, _ = ref_moe.router_topk(jnp.asarray(x.numpy()), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    assert int((got[2] > 0).sum()) == 1 and int((want[2] > 0).sum()) == 1


# -- the three dispatches ------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_mlp_matches_reference(arch, dtype, ref_dots):
    rcfg, cfg, jp, tp = _layer_pair(arch, dtype)
    jx, tx = _hidden((2, 9, cfg.d_model), rcfg.dtype)
    yw, aw, zw = ref_moe.moe_mlp(jp, rcfg, jx)
    yg, ag, zg = moe.moe_mlp(tp, cfg, tx)
    assert yg.dtype == cfg.param_dtype and yg.shape == tx.shape
    np.testing.assert_allclose(_np(yg), np.asarray(yw.astype(jnp.float32)), atol=TOL[dtype], rtol=0)
    assert float(ag) == pytest.approx(float(aw), abs=1e-5)
    assert float(zg) == pytest.approx(float(zw), abs=1e-5)
    np.testing.assert_allclose(_np(moe.moe_mlp_serve(tp, cfg, tx)), _np(yg), atol=TOL[dtype], rtol=0)


GROUPED = {
    "ample": dict(shape=(2, 24), capacity_factor=8.0, group_size=64),
    "tight": dict(shape=(2, 24), capacity_factor=0.5, group_size=64),
    "reshape": dict(shape=(2, 27), capacity_factor=1.25, group_size=8),  # 54 tokens: g 9 of 6 (the while loop)
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(GROUPED))
def test_moe_mlp_grouped_matches_reference(case, dtype, ref_dots):
    """The capacity dispatch with ample capacity, with dropped tokens, and
    past ``2 * group_size`` tokens a row (the (g, tg) reshape path)."""
    kw = dict(GROUPED[case])
    b, s = kw.pop("shape")
    rcfg, cfg, jp, tp = _layer_pair("dbrx-132b", dtype)
    jx, tx = _hidden((b, s, cfg.d_model), rcfg.dtype, seed=2)
    yw, aw, zw = ref_moe.moe_mlp_grouped(jp, rcfg, jx, **kw)
    yg, ag, zg = moe.moe_mlp_grouped(tp, cfg, tx, **kw)
    assert yg.dtype == cfg.param_dtype
    np.testing.assert_allclose(_np(yg), np.asarray(yw.astype(jnp.float32)), atol=TOL[dtype], rtol=0)
    assert float(ag) == pytest.approx(float(aw), abs=1e-5)
    assert float(zg) == pytest.approx(float(zw), abs=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_mlp_sparse_matches_reference(dtype, ref_dots):
    rcfg, cfg, jp, tp = _layer_pair("granite-moe-3b-a800m", dtype)
    jx, tx = _hidden((2, 8, cfg.d_model), rcfg.dtype, seed=3)
    yw = ref_moe.moe_mlp_sparse(jp, rcfg, jx)
    yg = moe.moe_mlp_sparse(tp, cfg, tx)
    np.testing.assert_allclose(_np(yg), np.asarray(yw.astype(jnp.float32)), atol=TOL[dtype], rtol=0)


# -- tests/test_consistency.py's three properties, on the port -----------------
def test_grouped_equals_dense_with_ample_capacity():
    _, cfg, _, tp = _layer_pair("dbrx-132b")
    x = torch.randn((2, 64, cfg.d_model), generator=torch.Generator().manual_seed(1)) * 0.5
    y_d = moe.moe_mlp(tp, cfg, x)[0]
    y_g = moe.moe_mlp_grouped(tp, cfg, x, capacity_factor=8.0, group_size=64)[0]
    assert float((y_d - y_g).abs().max()) < 1e-4


def test_sparse_equals_dense():
    _, cfg, _, tp = _layer_pair("granite-moe-3b-a800m")
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator().manual_seed(1)) * 0.5
    assert float((moe.moe_mlp(tp, cfg, x)[0] - moe.moe_mlp_sparse(tp, cfg, x)).abs().max()) < 1e-4


def test_dropped_tokens_get_zero_output():
    """Capacity overflow drops tokens: tight capacity differs from ample but
    stays finite."""
    _, cfg, _, tp = _layer_pair("dbrx-132b")
    x = torch.randn((1, 64, cfg.d_model), generator=torch.Generator().manual_seed(1))
    y_tight = moe.moe_mlp_grouped(tp, cfg, x, capacity_factor=0.25, group_size=64)[0]
    y_ample = moe.moe_mlp_grouped(tp, cfg, x, capacity_factor=8.0, group_size=64)[0]
    assert bool(torch.isfinite(y_tight).all())
    assert float((y_tight - y_ample).abs().max()) > 1e-6


@pytest.mark.parametrize("dispatch", ["dense", "grouped"])
def test_one_hot_paths_run_under_vmap_of_grad(dispatch):
    """Both dispatches' one-hot paths run under ``torch.func.vmap(grad)``
    (the federated cohort's form), each client's gradient its own."""
    _, cfg, _, tp = _layer_pair("dbrx-132b")
    run = moe.moe_mlp if dispatch == "dense" else (
        lambda p, c, x: moe.moe_mlp_grouped(p, c, x, capacity_factor=1.0, group_size=8))

    def loss(p, x):
        y, aux, z = run(p, cfg, x)
        return y.square().mean() + 1e-2 * aux + 1e-3 * z

    stacked = jax.tree.map(lambda a: torch.stack([a, a * 0.9, a * 1.1]), tp)
    xs = torch.randn((3, 2, 20, cfg.d_model), generator=torch.Generator().manual_seed(5))
    grads = torch.func.vmap(torch.func.grad(loss))(stacked, xs)
    for c in range(3):
        one = jax.tree.map(lambda a: a[c], stacked)
        want = torch.func.grad(loss)(one, xs[c])
        for gw, gg in zip(jax.tree.leaves(want), jax.tree.leaves(jax.tree.map(lambda a: a[c], grads))):
            np.testing.assert_allclose(gg.numpy(), gw.numpy(), atol=1e-6, rtol=1e-5)


# -- the transformer -----------------------------------------------------------
@pytest.fixture(scope="module", params=ARCHS)
def model_pair(request):
    rcfg, cfg = ref_smoke(request.param), get_smoke_config(request.param)
    jp = ref_init_params(jax.random.PRNGKey(0), rcfg)
    return rcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def test_forward_matches_reference_with_router_losses(model_pair):
    """Logits 1e-5, the summed aux and z losses 1e-5, at a call under 4096
    tokens (dense dispatch); ``forward_hidden`` carries the same losses."""
    rcfg, cfg, jp, tp = model_pair
    x = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    lw, aw = ref_forward(jp, rcfg, jnp.asarray(x))
    lg, ag = forward(tp, cfg, torch.as_tensor(x))
    np.testing.assert_allclose(lg.numpy(), np.asarray(lw), atol=1e-5, rtol=0)
    for key in ("moe_aux", "moe_z"):
        assert float(ag[key]) == pytest.approx(float(aw[key]), abs=1e-5)
        assert float(forward_hidden(tp, cfg, torch.as_tensor(x))[1][key]) == float(ag[key])


def test_prefill_and_decode_match_reference_through_topk_gating(model_pair, monkeypatch):
    """Prefill and two decode steps against the reference's (logits 1e-5).
    The serving functions take their combine weights from ``topk_gating``,
    one call per MoE layer of each call; ``forward`` never calls it."""
    rcfg, cfg, jp, tp = model_pair
    calls = []

    def counted(logits, k):
        calls.append(tuple(logits.shape))
        return topk_gating_ref(logits, k)

    monkeypatch.setattr(moe, "topk_gating", counted)
    x = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    forward(tp, cfg, torch.as_tensor(x))
    assert calls == []
    lw, cw = ref_prefill(jp, rcfg, jnp.asarray(x), max_seq=24)
    lg, cg = prefill(tp, cfg, torch.as_tensor(x), max_seq=24)
    np.testing.assert_allclose(lg.numpy(), np.asarray(lw), atol=1e-5, rtol=0)
    assert calls == [(40, cfg.moe.n_experts)] * cfg.n_layers
    for step in range(2):
        tok = np.asarray(lw).argmax(-1).astype(np.int32)
        pos = np.full((2,), 20 + step, np.int32)
        lw, cw = ref_decode_step(jp, rcfg, jnp.asarray(tok), cw, jnp.asarray(pos))
        lg, cg = decode_step(tp, cfg, torch.as_tensor(tok).long(), cg, torch.as_tensor(pos).long())
        np.testing.assert_allclose(lg.numpy(), np.asarray(lw), atol=1e-5, rtol=0)
    assert calls[cfg.n_layers:] == [(2, cfg.moe.n_experts)] * (2 * cfg.n_layers)


def test_decode_keeps_the_dense_dispatch_above_the_capacity_switch(model_pair, monkeypatch):
    """A decode step takes the dense dispatch at any batch, as the
    reference's: with the capacity switch lowered under the batch's token
    count it still calls ``topk_gating`` once per MoE layer and never the
    capacity dispatch, and matches the reference's step (logits 1e-5)."""
    import repro_torch.models.transformer as transformer

    rcfg, cfg, jp, tp = model_pair
    x = np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 12)).astype(np.int32)
    lw, cw = ref_prefill(jp, rcfg, jnp.asarray(x), max_seq=16)
    lg, cg = prefill(tp, cfg, torch.as_tensor(x), max_seq=16)
    calls = []

    def counted(logits, k):
        calls.append(tuple(logits.shape))
        return topk_gating_ref(logits, k)

    def refused(*args, **kwargs):
        raise AssertionError("decode_step took the capacity dispatch")

    monkeypatch.setattr(moe, "topk_gating", counted)
    monkeypatch.setattr(moe, "moe_mlp_grouped", refused)
    monkeypatch.setattr(transformer, "GROUPED_DISPATCH_TOKENS", 2)
    tok = np.asarray(lw).argmax(-1).astype(np.int32)
    pos = np.full((3,), 12, np.int32)
    lw, _ = ref_decode_step(jp, rcfg, jnp.asarray(tok), cw, jnp.asarray(pos))
    lg, _ = decode_step(tp, cfg, torch.as_tensor(tok).long(), cg, torch.as_tensor(pos).long())
    np.testing.assert_allclose(lg.numpy(), np.asarray(lw), atol=1e-5, rtol=0)
    assert calls == [(3, cfg.moe.n_experts)] * cfg.n_layers


def test_bf16_moe_params_cross_exactly():
    """A bf16 MoE tree crosses both ways bit for bit: the (n_blocks, E,
    d_in, d_out) expert stacks in bf16, the router in fp32."""
    from repro_torch.convert import params_to_numpy

    rcfg = dataclasses.replace(ref_smoke("granite-moe-3b-a800m"), dtype="bfloat16")
    ref = jax.tree.map(np.asarray, ref_init_params(jax.random.PRNGKey(0), rcfg))
    tp = params_from_numpy(ref)
    ffn = tp["blocks"][0]["ffn"]
    assert ffn["wi"].shape == (rcfg.n_layers, rcfg.moe.n_experts, rcfg.d_model, rcfg.d_ff)
    assert ffn["wi"].dtype == torch.bfloat16 and ffn["router"]["w"].dtype == torch.float32
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(params_to_numpy(tp)), strict=True):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# -- the program -----------------------------------------------------------------
def test_tiny_moe_config_and_registry_match_reference():
    assert dataclasses.asdict(tiny_moe_config()) == dataclasses.asdict(ref_tiny_moe_config())
    assert dataclasses.asdict(tiny_moe_config(vocab_size=64, n_experts=8, top_k=1)) == dataclasses.asdict(
        ref_tiny_moe_config(vocab_size=64, n_experts=8, top_k=1)
    )
    prog = PROGRAMS.get("moe")(vocab_size=64, seq_len=16, n_topics=3, aux_weight=0.1)
    ref = REF_PROGRAMS.get("moe")(vocab_size=64, seq_len=16, n_topics=3, aux_weight=0.1)
    assert prog == MoEProgram(cfg=tiny_moe_config(vocab_size=64, seq_len=16), seq_len=16, n_topics=3, aux_weight=0.1)
    assert (prog.name, prog.feat_shape, prog.n_classes, prog.aux_weight, prog.z_weight) == (
        ref.name, ref.feat_shape, ref.n_classes, ref.aux_weight, ref.z_weight
    )
    assert reference_program(prog) == ref


def test_moe_program_loss_and_gradient_match_reference():
    """Loss (next-token + 1e-2 aux + 1e-3 z) 1e-5 and its gradient 1e-5 on
    the reference's parameters; metric 1e-6; the mapped cohort loss equals
    each client's own."""
    prog = PROGRAMS.get("moe")()
    ref = reference_program(prog)
    jp = ref.init(jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(2).integers(0, 128, (4, 32)).astype(np.int32)
    y = np.zeros(4, np.int32)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    want, gw = jax.value_and_grad(lambda p: ref.loss(p, jnp.asarray(x), jnp.asarray(y)))(jp)
    leaves = jax.tree.leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    got = prog.loss(tp, xt, yt)
    gg = torch.autograd.grad(got, leaves)
    assert float(got.detach()) == pytest.approx(float(want), abs=1e-5)
    logits, aux = forward(tp, prog.cfg, xt)
    extra = 1e-2 * aux["moe_aux"] + 1e-3 * aux["moe_z"]
    assert float(got.detach()) == pytest.approx(float(lm_loss(logits, xt, shift=True) + extra), abs=1e-6)
    for a, b in zip(gg, jax.tree.leaves(gw), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)
    with torch.no_grad():
        assert float(prog.metric(tp, xt, yt)) == pytest.approx(float(ref.metric(jp, jnp.asarray(x), jnp.asarray(y))),
                                                               abs=1e-6)
        stacked = jax.tree.map(lambda a: torch.stack([a, a * 0.5]), tp)
        xs = torch.stack([xt, xt.flip(0)])
        cohort = prog.cohort_loss(stacked, xs, torch.stack([yt, yt]))
        for c in range(2):
            one = jax.tree.map(lambda a: a[c], stacked)
            assert float(cohort[c]) == pytest.approx(float(prog.loss(one, xs[c], yt)), abs=1e-6)


# -- the MoE token population on every engine ---------------------------------
def _datasets_equal(a, b):
    assert a.x.dtype == b.x.dtype and a.y.dtype == b.y.dtype and a.n_classes == b.n_classes
    assert a.x.tobytes() == np.asarray(b.x).tobytes() and a.y.tobytes() == np.asarray(b.y).tobytes()


def test_moe_population_byte_equal_to_reference():
    """``build_scenario(model="moe")`` and ``("lm", model="moe")``: shards,
    test set, topic counts and payload size as the reference's; the lazy
    population's source, test set and assignment too."""
    ref = ref_build(model="moe", **POP)
    for sc in (build_scenario(model="moe", device="cpu", **POP), build_scenario("lm", model="moe", device="cpu", **POP)):
        assert sc.name == ref.name == "moe" and sc.program == PROGRAMS.get("moe")(vocab_size=64, seq_len=16, n_topics=3)
        assert sc.class_counts.tobytes() == np.asarray(ref.class_counts).tobytes()
        for c, rc in zip(sc.clients, ref.clients, strict=True):
            _datasets_equal(c.shard, rc.shard)
        _datasets_equal(sc.test, ref.test)
        assert sc.model_bits == ref.model_bits
    lazy = dict(lazy=True, n_eus=60, n_edges=3, seed=2, n_test_per_class=16)
    ref = ref_build("lm", model="moe", **lazy)
    sc = build_scenario("lm", model="moe", device="cpu", **lazy)
    assert sc.name == ref.name == "lm-stream-moe" and sc.model_bits == ref.model_bits
    _datasets_equal(sc.test, ref.test)
    assert sc.edge_of.tobytes() == ref.edge_of.tobytes()
    for cid in (0, 31, 59):
        _datasets_equal(sc.source.shard(cid), ref.source.shard(cid))


ENGINES = {
    "reference": ("reference", {}),
    "sync-device": ("sync", {"pipeline": "device"}),
    "sync-host": ("sync", {"pipeline": "host"}),
    "async": ("async", {}),
}


@pytest.fixture(scope="module")
def moe_runs():
    """Two cloud rounds of every engine on the MoE population in both
    packages, the port from the reference's initial parameters."""
    with reference_inits():
        sc = build_scenario(model="moe", hparams=CAPPED, device="cpu", **POP)
        ref = ReferencePopulation(sc)
        sc = dataclasses.replace(sc, cost=ref.cost)
        lam = sc.assign("eara-sca", device="cpu").lam
        out = {}
        for engine, (name, kw) in ENGINES.items():
            rkw = dict(kw, latency=ref.cost.latency) if name == "async" else dict(kw)
            out[engine] = (ref.simulate(lam, 2, engine=name, seed=3, **rkw),
                           sc.simulate(lam, 2, engine=name, seed=3, device="cpu", **kw))
        yield out


@pytest.mark.parametrize("engine", list(ENGINES))
def test_moe_engines_match_reference(moe_runs, engine):
    """Per-round next-token accuracy 1e-6, loss 1e-5, parameters 5e-3,
    traffic exact; the loss carries the router's losses (finite, > 0)."""
    want, got = moe_runs[engine]
    check_run(want, got)
    assert len(got.history) == 2 and all(np.isfinite(m.mean_local_loss) and m.mean_local_loss > 0 for m in got.history)


def test_lm_moe_mix_matches_reference():
    """``model_mix={"lm": 4, "moe": 2}`` on the token population: the
    reference's name and public token pools byte for byte; one round of the
    sync device pipeline held to the reference's (accuracy 1e-6, loss 5e-3,
    parameters 1e-3, as ``tests/test_torch_distill.py`` holds the mixed
    heartbeat population) and the port's readable simulator to it (the
    reference's simulator compiles one program per client shape, ~40 s),
    ``final_params`` keyed by program."""
    ref_sc = ref_build(model_mix=MIX, **{k: v for k, v in MIX_POP.items() if k != "hparams"})
    with reference_inits():
        sc = build_scenario(model_mix=MIX, device="cpu", **MIX_POP)
        ref = ReferencePopulation(sc)
        sc = dataclasses.replace(sc, cost=ref.cost)
        assert sc.name == ref_sc.name == "mix(lm+moe)" and sc.is_hetero and sc.distill is not None
        assert len(sc.public) == len(ref_sc.public) == 2
        for a, b in zip(sc.public, ref_sc.public):
            _datasets_equal(a, b)
        assert sc.model_bits == ref_sc.model_bits
        lam = sc.assign("eara-sca", device="cpu").lam
        got = sc.simulate(lam, 1, engine="sync", device="cpu")
        assert set(got.final_params) == {"lm", "moe"}
        check_run(ref.simulate(lam, 1, engine="sync"), got, loss_tol=5e-3, param_tol=1e-3)
        check_run(sc.simulate(lam, 1, device="cpu"), got, loss_tol=5e-3, param_tol=1e-3, flat_want=flat)


# -- serving ---------------------------------------------------------------------
def _serve(engine, prompts, new, request_cls):
    return [r.out for r in engine.run([request_cls(p.copy(), max_new_tokens=new) for p in prompts])]


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
def test_uniform_batch_serves_as_the_reference(model_pair, use_flash):
    rcfg, cfg, jp, tp = model_pair
    prompts = [p for p in np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 30)).astype(np.int32)]
    ref = _serve(RefServeEngine(rcfg, params=jp, max_seq=40), prompts, 6, RefRequest)
    out = _serve(ServeEngine(dataclasses.replace(cfg, use_flash=use_flash), params=tp, max_seq=40, device="cpu"),
                 prompts, 6, Request)
    for a, b in zip(out, ref, strict=True):
        np.testing.assert_array_equal(a, b)


def test_ragged_batch_serves_as_the_reference_and_solo(model_pair):
    """A ragged batch (under 4096 tokens, so the dense dispatch, where each
    token is routed on its own) is token-identical to the reference's and
    to each request served alone."""
    rcfg, cfg, jp, tp = model_pair
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (5, 9, 9, 3)]
    ref = _serve(RefServeEngine(rcfg, params=jp, max_seq=24), prompts, 6, RefRequest)
    eng = ServeEngine(cfg, params=tp, max_seq=24, device="cpu")
    out = _serve(eng, prompts, 6, Request)
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(out[i], ref[i])
        np.testing.assert_array_equal(out[i], _serve(eng, [p], 6, Request)[0])


@pytest.mark.parametrize("arch,item", [("jamba-1.5-large-398b", "10c"), ("rwkv6-7b", "10c"), ("whisper-tiny", "10d")])
def test_queued_families_name_their_item(arch, item):
    """The families after MoE: the hybrid (MoE plus Mamba) and ssm families,
    ported by item 10c, and encdec (whisper), ported by item 10d, serve a
    uniform batch token-identical to the reference's on the same
    parameters (whisper on the same frame embeddings)."""
    rcfg, cfg = ref_smoke(arch), get_smoke_config(arch)
    jp = ref_init_params(jax.random.PRNGKey(1), rcfg)
    rng = np.random.default_rng(5)
    prompts = list(rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32))
    kw, ref_kw = {}, {}
    if item == "10d":
        kw["enc_embeds"] = rng.standard_normal((2, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
        ref_kw["enc_embeds"] = jnp.asarray(kw["enc_embeds"])
    ref = [r.out for r in RefServeEngine(rcfg, params=jp, max_seq=24).run(
        [RefRequest(p.copy(), max_new_tokens=4) for p in prompts], **ref_kw)]
    out = [r.out for r in ServeEngine(cfg, params=params_from_numpy(jax.tree.map(np.asarray, jp)), max_seq=24,
                                      device="cpu").run([Request(p.copy(), max_new_tokens=4) for p in prompts], **kw)]
    for a, b in zip(out, ref, strict=True):
        np.testing.assert_array_equal(a, b)
