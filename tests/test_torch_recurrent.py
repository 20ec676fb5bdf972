"""The recurrent families against the JAX package's on the same numpy inputs
and parameters: the Mamba and RWKV mixers (chunked, with their returned
state, and one decode step), the hybrid (jamba) and ssm (rwkv6) stacks'
forward, prefill and decode, ``ServeEngine``'s exact-length buckets on
ragged batches, the refusals the reference makes, ``MambaProgram`` and
``RWKVProgram``, their token populations on the sync engine and the
``{"lm", "mamba", "rwkv"}`` mix.

Tolerances: the mixers and stacks 1e-5 in fp32 (the reference's kernel
tolerance; the port's in-chunk Mamba scan combines in another order than
``jax.lax.associative_scan``) and 2e-2 in bf16; the chunked mixers against
their own decode steps 1e-4 (``tests/test_consistency.py``'s bound); the
programs' loss 1e-5 and gradient 1e-4; the engines as ``check_run`` holds
the LM (accuracy 1e-6, loss 1e-5, parameters 5e-3, traffic exact), the mix
as ``tests/test_torch_moe.py`` holds the LM/MoE mix; served and greedy
tokens exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.models.mamba as ref_mamba  # noqa: E402
import repro.models.rwkv as ref_rwkv  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.federated import build_scenario as ref_build  # noqa: E402
from repro.federated.programs import PROGRAMS as REF_PROGRAMS  # noqa: E402
from repro.federated.programs import tiny_mamba_config as ref_tiny_mamba_config  # noqa: E402
from repro.federated.programs import tiny_rwkv_config as ref_tiny_rwkv_config  # noqa: E402
from repro.models import forward as ref_forward  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.models.transformer import decode_step as ref_decode_step  # noqa: E402
from repro.models.transformer import prefill as ref_prefill  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402
from repro.serving import ServeEngine as RefServeEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.federated import (  # noqa: E402
    PROGRAMS,
    MambaProgram,
    RWKVProgram,
    build_scenario,
    tiny_mamba_config,
    tiny_rwkv_config,
)
from repro_torch.models import mamba, rwkv  # noqa: E402
from repro_torch.models.transformer import decode_step, forward, init_cache, prefill  # noqa: E402
from repro_torch.serving import Request, ServeEngine  # noqa: E402
from repro_torch.training.loss import lm_loss  # noqa: E402
from torch_parity import ReferencePopulation, check_run, reference_inits, reference_program  # noqa: E402

JAMBA, RWKV6 = "jamba-1.5-large-398b", "rwkv6-7b"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# each mixer: its smoke config, the reference's module, the port's, and
# the names of its init, mixer, state and decode functions
MIXERS = {
    "mamba": (JAMBA, ref_mamba, mamba, "mamba_init", "mamba_mixer", "mamba_init_state", "mamba_decode_step"),
    "rwkv": (RWKV6, ref_rwkv, rwkv, "rwkv_init", "rwkv_mixer", "rwkv_init_state", "rwkv_decode_step"),
}
# a small cut of the token population: 6 EUs over 2 edges, local epochs
# capped at 4 steps (few cohort shapes for the reference)
POP = dict(lm_eus=6, lm_edges=2, scale=0.1, n_test_per_class=8, seed=0)
CAPPED = [{"max_steps": 4}] * 6
MIX = {"lm": 6, "mamba": 3, "rwkv": 3}
MIX_POP = dict(scale=0.05, seed=0, n_test_per_class=8, lm_seq_len=16, lm_vocab=64, hparams=[{"max_steps": 4}] * 12)
LAZY = dict(lazy=True, n_eus=60, n_edges=3, seed=2, n_test_per_class=16)


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(jnp.asarray(want).astype(jnp.float32)), atol=tol, rtol=0)


@pytest.fixture
def ref_dots(monkeypatch):
    """Lets the reference's bf16 projections run here (XLA's CPU runtime has
    no bf16 x bf16 -> fp32 dot): such an einsum gets its operands upcast to
    fp32, the same exact products accumulated in fp32, as
    ``tests/test_torch_moe.py`` does."""
    einsum = jnp.einsum

    def einsum_f32(eq, *ops, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.float32:
            ops = [o.astype(jnp.float32) for o in ops]
        return einsum(eq, *ops, preferred_element_type=preferred_element_type, **kw)

    monkeypatch.setattr(jnp, "einsum", einsum_f32)


def _mixer_pair(kind, dtype="float32", seed=0):
    """(reference cfg, port cfg, reference module, port module, names,
    reference params, port params) of one mixer layer."""
    arch, ref_mod, mod, *names = MIXERS[kind]
    rcfg = dataclasses.replace(ref_smoke(arch), dtype=dtype)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    jp = getattr(ref_mod, names[0])(jax.random.PRNGKey(seed), rcfg)
    return rcfg, cfg, ref_mod, mod, names, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _hidden(shape, dtype, seed=1, scale=0.5):
    x = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    return jx, params_from_numpy(np.asarray(jx))


def _random_state(state, seed):
    """A non-zero decode state of ``state``'s shapes and dtypes (numpy)."""
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(np.shape(v)) * 0.3).astype(np.float32) for k, v in state.items()}


# -- the mixers ------------------------------------------------------------------
@pytest.mark.parametrize("seq", [16, 20, 24])
@pytest.mark.parametrize("kind", list(MIXERS))
def test_mixer_matches_reference(kind, seq):
    """The chunked mixer (chunk 8) at 1e-5, and with ``return_state`` its
    final state too.  S 20 pads the last chunk: Mamba then refuses the
    state (the reference's assert, the port's ``ValueError``), RWKV drops
    to ``gcd(8, 20) = 4``-token chunks."""
    rcfg, cfg, ref_mod, mod, names, jp, tp = _mixer_pair(kind)
    jx, tx = _hidden((2, seq, cfg.d_model), jnp.float32, seed=seq)
    run_ref, run = getattr(ref_mod, names[1]), getattr(mod, names[1])
    y = run(tp, cfg, tx, chunk=8)
    assert y.shape == tx.shape and y.dtype == torch.float32
    _close(y, run_ref(jp, rcfg, jx, chunk=8), 1e-5)
    if kind == "mamba" and seq % 8:
        with pytest.raises(AssertionError, match="return_state requires seq % chunk == 0"):
            run_ref(jp, rcfg, jx, chunk=8, return_state=True)
        with pytest.raises(ValueError, match="return_state requires seq % chunk == 0"):
            run(tp, cfg, tx, chunk=8, return_state=True)
        return
    yw, sw = run_ref(jp, rcfg, jx, chunk=8, return_state=True)
    yg, sg = run(tp, cfg, tx, chunk=8, return_state=True)
    _close(yg, yw, 1e-5)
    assert set(sg) == set(sw)
    for key in sw:
        assert sg[key].dtype == torch.float32 and tuple(sg[key].shape) == sw[key].shape
        _close(sg[key], sw[key], 1e-5)


@pytest.mark.parametrize("kind", list(MIXERS))
def test_decode_step_matches_reference(kind):
    """One decode step from a non-zero state: output and new state 1e-5;
    the given state is not written."""
    rcfg, cfg, ref_mod, mod, names, jp, tp = _mixer_pair(kind)
    jx, tx = _hidden((3, 1, cfg.d_model), jnp.float32, seed=4)
    state = _random_state(getattr(ref_mod, names[2])(rcfg, 3), seed=5)
    before = params_from_numpy(state)
    given = params_from_numpy(state)
    yw, sw = getattr(ref_mod, names[3])(jp, rcfg, jx, jax.tree.map(jnp.asarray, state))
    yg, sg = getattr(mod, names[3])(tp, cfg, tx, given)
    _close(yg, yw, 1e-5)
    for key in sw:
        _close(sg[key], sw[key], 1e-5)
        assert torch.equal(given[key], before[key])


@pytest.mark.parametrize("kind", list(MIXERS))
def test_bf16_mixer_matches_reference(kind, ref_dots):
    """In bf16 the casts sit where the reference has them: the chunked
    mixer, its fp32 state and one decode step at 2e-2."""
    rcfg, cfg, ref_mod, mod, names, jp, tp = _mixer_pair(kind, "bfloat16")
    assert tp["out_proj" if kind == "mamba" else "wo"]["w"].dtype == torch.bfloat16
    fp32_leaves = ("a_log", "d_skip") if kind == "mamba" else ("w_base", "bonus")
    assert all(tp[k].dtype == torch.float32 for k in fp32_leaves)
    jx, tx = _hidden((2, 16, cfg.d_model), jnp.bfloat16, seed=6)
    yw, sw = getattr(ref_mod, names[1])(jp, rcfg, jx, chunk=8, return_state=True)
    yg, sg = getattr(mod, names[1])(tp, cfg, tx, chunk=8, return_state=True)
    assert yg.dtype == torch.bfloat16
    _close(yg, yw, TOL["bfloat16"])
    for key in sw:
        assert sg[key].dtype == torch.float32
        _close(sg[key], sw[key], TOL["bfloat16"])
    j1, t1 = _hidden((2, 1, cfg.d_model), jnp.bfloat16, seed=7)
    yw, sw = getattr(ref_mod, names[3])(jp, rcfg, j1, sw)
    yg, sg = getattr(mod, names[3])(tp, cfg, t1, sg)
    _close(yg, yw, TOL["bfloat16"])
    for key in sw:
        _close(sg[key], sw[key], TOL["bfloat16"])


@pytest.mark.parametrize("kind,seq", [("mamba", 29), ("rwkv", 23)])
def test_chunked_equals_step(kind, seq):
    """``tests/test_consistency.py``'s property on the port: the chunked
    mixer (chunk 8, a padded last chunk) equals stepping its decode step
    over the same tokens from the zero state (1e-4)."""
    _, cfg, _, mod, names, _, tp = _mixer_pair(kind)
    x = torch.randn((2, seq, cfg.d_model), generator=torch.Generator().manual_seed(1)) * 0.5
    y_chunk = getattr(mod, names[1])(tp, cfg, x, chunk=8)
    st = getattr(mod, names[2])(cfg, 2, device="cpu")
    ys = []
    for t in range(seq):
        yt, st = getattr(mod, names[3])(tp, cfg, x[:, t : t + 1], st)
        ys.append(yt)
    assert float((y_chunk - torch.cat(ys, 1)).abs().max()) < 1e-4


@pytest.mark.parametrize("kind", list(MIXERS))
def test_mixer_runs_under_vmap_of_grad(kind):
    """The mixer writes nothing in place: it runs under
    ``torch.func.vmap(grad)`` (the federated cohort's form), each client's
    gradient its own (1e-6)."""
    _, cfg, _, mod, names, _, tp = _mixer_pair(kind)
    run = getattr(mod, names[1])

    def loss(p, x):
        return run(p, cfg, x, chunk=8).square().mean()

    stacked = jax.tree.map(lambda a: torch.stack([a, a * 0.9, a * 1.1]), tp)
    xs = torch.randn((3, 2, 12, cfg.d_model), generator=torch.Generator().manual_seed(5)) * 0.5
    grads = torch.func.vmap(torch.func.grad(loss))(stacked, xs)
    for c in range(3):
        want = torch.func.grad(loss)(jax.tree.map(lambda a: a[c], stacked), xs[c])
        got = jax.tree.map(lambda a: a[c], grads)
        for gw, gg in zip(jax.tree.leaves(want), jax.tree.leaves(got), strict=True):
            assert bool(torch.isfinite(gg).all())
            np.testing.assert_allclose(gg.numpy(), gw.numpy(), atol=1e-6, rtol=1e-5)


def test_rwkv_masked_exponent_keeps_the_gradient_finite():
    """A decay at its floor (w = 0, log clamped to 1e-12) makes the pairwise
    exponent's masked entries large and positive; the mask comes before
    ``exp``, so the forward and the gradient stay finite."""
    _, cfg, _, _, _, _, tp = _mixer_pair("rwkv")
    tp = dict(tp, w_base=torch.full_like(tp["w_base"], 6.0))  # w = exp(-exp(6 + ...)) underflows to 0
    x = torch.randn((1, 16, cfg.d_model), generator=torch.Generator().manual_seed(2))
    leaves = [tp["wk"]["w"].clone().requires_grad_(True)]
    y = rwkv.rwkv_mixer(dict(tp, wk={"w": leaves[0]}), cfg, x, chunk=16)
    (g,) = torch.autograd.grad(y.square().sum(), leaves)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(g).all())


# -- the stacks ------------------------------------------------------------------
@pytest.fixture(scope="module", params=[JAMBA, RWKV6])
def model_pair(request):
    rcfg, cfg = ref_smoke(request.param), get_smoke_config(request.param)
    jp = ref_init_params(jax.random.PRNGKey(0), rcfg)
    return rcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def test_params_cross_exactly_with_their_dtypes(model_pair):
    """The reference's tree crosses both ways bit for bit, each leaf in its
    own dtype: in a bf16 tree the fp32 leaves (``a_log``, ``d_skip``,
    ``w_base``, ``bonus``) stay fp32."""
    rcfg = dataclasses.replace(model_pair[0], dtype="bfloat16")
    ref = jax.tree.map(np.asarray, ref_init_params(jax.random.PRNGKey(0), rcfg))
    tp = params_from_numpy(ref)
    mixer = tp["blocks"][-1]["mixer"]
    fp32 = ("a_log", "d_skip") if rcfg.family == "hybrid" else ("w_base", "bonus")
    assert all(mixer[k].dtype == torch.float32 for k in fp32)
    assert tp["embed"]["emb"].dtype == torch.bfloat16
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(params_to_numpy(tp)), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_forward_matches_reference(model_pair):
    rcfg, cfg, jp, tp = model_pair
    x = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    lw, aw = ref_forward(jp, rcfg, jnp.asarray(x))
    lg, ag = forward(tp, cfg, torch.as_tensor(x))
    np.testing.assert_allclose(lg.numpy(), np.asarray(lw), atol=1e-5, rtol=0)
    for key in ("moe_aux", "moe_z"):
        assert float(ag[key]) == pytest.approx(float(aw[key]), abs=1e-5)


def test_prefill_and_decode_match_reference(model_pair):
    """Prefill and 8 decode steps: logits 1e-5 at every step, the caches'
    states 1e-5 after them, identical greedy tokens."""
    rcfg, cfg, jp, tp = model_pair
    x = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    lw, cw = ref_prefill(jp, rcfg, jnp.asarray(x), max_seq=40)
    lg, cg = prefill(tp, cfg, torch.as_tensor(x), max_seq=40)
    np.testing.assert_allclose(lg.numpy(), np.asarray(lw), atol=1e-5, rtol=0)
    for step in range(8):
        tok = np.asarray(lw).argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(lg.argmax(-1).numpy(), tok)
        pos = np.full((2,), 24 + step, np.int32)
        lw, cw = ref_decode_step(jp, rcfg, jnp.asarray(tok), cw, jnp.asarray(pos))
        lg, cg = decode_step(tp, cfg, torch.as_tensor(tok).long(), cg, torch.as_tensor(pos).long())
        np.testing.assert_allclose(lg.numpy(), np.asarray(lw), atol=1e-5, rtol=0)
    for cw_pos, cg_pos in zip(cw, cg, strict=True):
        assert set(cg_pos) == set(cw_pos)
        for key in cw_pos:
            np.testing.assert_allclose(_np(cg_pos[key]), np.asarray(cw_pos[key], np.float32), atol=1e-5, rtol=0)


def test_decode_advances_the_state_in_place(model_pair):
    """``init_cache`` gives every recurrent leaf its own zeroed fp32 memory
    (no row or layer aliases another); ``decode_step`` writes each layer's
    new state into the cache it was given, so N tokens decoded one by one
    from a one-token prefill equal the chunked prefill of the same tokens
    (logits and states 1e-5)."""
    _, cfg, _, tp = model_pair
    cache = init_cache(cfg, 3, 16, device="cpu")
    leaves = [t for c in cache for key, t in c.items() if key not in ("k", "v")]
    assert leaves
    for t in leaves:
        assert t.dtype == torch.float32 and t.is_contiguous() and not bool(t.any())
    ptrs = {t[l, b].data_ptr() for t in leaves for l in range(t.shape[0]) for b in range(t.shape[1])}
    assert len(ptrs) == sum(t.shape[0] * t.shape[1] for t in leaves)
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab_size, (3, 12)))
    want_logits, want_cache = prefill(tp, cfg, toks, max_seq=16)
    logits, cache = prefill(tp, cfg, toks[:, :1], max_seq=16)
    for t in range(1, 12):
        given = cache
        logits, cache = decode_step(tp, cfg, toks[:, t : t + 1], cache, torch.full((3,), t))
        assert cache is given
    np.testing.assert_allclose(logits.numpy(), want_logits.numpy(), atol=1e-5, rtol=0)
    for c, w in zip(cache, want_cache, strict=True):
        for key in c:
            if key not in ("k", "v"):
                np.testing.assert_allclose(c[key].numpy(), w[key].numpy(), atol=1e-5, rtol=0)


def test_pad_masked_prefill_is_refused(model_pair):
    """A pad mask on a stack with recurrent layers raises the reference's
    ``ValueError`` in both packages."""
    rcfg, cfg, jp, tp = model_pair
    x = np.zeros((2, 8), np.int32)
    mask = np.ones((2, 8), bool)
    match = "pad-masked prefill requires an attention-only stack"
    with pytest.raises(ValueError, match=match):
        ref_prefill(jp, rcfg, jnp.asarray(x), pad_mask=jnp.asarray(mask))
    with pytest.raises(ValueError, match=match):
        prefill(tp, cfg, torch.as_tensor(x), pad_mask=torch.as_tensor(mask))


def test_mamba_prompt_off_the_chunk_grid_is_refused():
    """A Mamba prefill of more than 128 tokens that is not a multiple of 128
    is refused, as the reference's (its assert), and not padded silently:
    through ``prefill`` and through ``ServeEngine``.  A multiple of 128
    runs."""
    rcfg, cfg, ref_mod, mod, _, jp, tp = _mixer_pair("mamba")
    jx, tx = _hidden((1, 200, cfg.d_model), jnp.float32)
    with pytest.raises(AssertionError, match="return_state requires"):
        ref_mod.mamba_mixer(jp, rcfg, jx, return_state=True)
    with pytest.raises(ValueError, match="return_state requires"):
        mod.mamba_mixer(tp, cfg, tx, return_state=True)
    params = params_from_numpy(jax.tree.map(np.asarray, ref_init_params(jax.random.PRNGKey(0), rcfg)))
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, 256).astype(np.int32)
    with pytest.raises(ValueError, match="return_state requires"):
        prefill(params, cfg, torch.as_tensor(prompt[None, :200]), max_seq=260)
    eng = ServeEngine(cfg, params=params, max_seq=260, device="cpu")
    with pytest.raises(ValueError, match="return_state requires"):
        eng.run([Request(prompt[:200], max_new_tokens=2)])
    assert eng.run([Request(prompt, max_new_tokens=2)])[0].out.shape == (2,)


# -- serving ---------------------------------------------------------------------
def _serve(engine, prompts, new, request_cls):
    return [r.out for r in engine.run([request_cls(p.copy(), max_new_tokens=new) for p in prompts])]


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
def test_uniform_batch_serves_as_the_reference(model_pair, use_flash):
    rcfg, cfg, jp, tp = model_pair
    prompts = list(np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 32)).astype(np.int32))
    ref = _serve(RefServeEngine(rcfg, params=jp, max_seq=40), prompts, 6, RefRequest)
    out = _serve(ServeEngine(dataclasses.replace(cfg, use_flash=use_flash), params=tp, max_seq=40, device="cpu"),
                 prompts, 6, Request)
    for a, b in zip(out, ref, strict=True):
        np.testing.assert_array_equal(a, b)


def test_ragged_batch_buckets_serve_as_the_reference_and_solo(model_pair, monkeypatch):
    """``tests/test_serving.py``'s ragged batch (lengths 5, 9, 9, 3: a
    repeated length) goes through one exact-length prefill per distinct
    length, never the pad mask; it is token-identical to the reference's
    and to each request served alone."""
    rcfg, cfg, jp, tp = model_pair
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (5, 9, 9, 3)]
    ref = _serve(RefServeEngine(rcfg, params=jp, max_seq=48), prompts, 6, RefRequest)
    eng = ServeEngine(cfg, params=tp, max_seq=48, device="cpu")
    shapes = []
    real = eng._prefill

    def counted(params, toks, **kw):
        assert "pad_mask" not in kw
        shapes.append(tuple(toks.shape))
        return real(params, toks, **kw)

    monkeypatch.setattr(eng, "_prefill", counted)
    out = _serve(eng, prompts, 6, Request)
    assert shapes == [(1, 3), (1, 5), (2, 9)]
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(out[i], ref[i])
        np.testing.assert_array_equal(out[i], _serve(eng, [p], 6, Request)[0])


# -- the programs -----------------------------------------------------------------
PROGRAM_CASES = {
    "mamba": (MambaProgram, tiny_mamba_config, ref_tiny_mamba_config, dict(d_state=4, expand=3)),
    "rwkv": (RWKVProgram, tiny_rwkv_config, ref_tiny_rwkv_config, dict(head_size=8, d_ff=48)),
}


@pytest.mark.parametrize("name", list(PROGRAM_CASES))
def test_tiny_config_and_registry_match_reference(name):
    cls, tiny, ref_tiny, knobs = PROGRAM_CASES[name]
    assert dataclasses.asdict(tiny()) == dataclasses.asdict(ref_tiny())
    assert dataclasses.asdict(tiny(vocab_size=64, **knobs)) == dataclasses.asdict(ref_tiny(vocab_size=64, **knobs))
    prog = PROGRAMS.get(name)(vocab_size=64, seq_len=16, n_topics=3, **knobs)
    ref = REF_PROGRAMS.get(name)(vocab_size=64, seq_len=16, n_topics=3, **knobs)
    assert prog == cls(cfg=tiny(vocab_size=64, seq_len=16, **knobs), seq_len=16, n_topics=3)
    assert (prog.name, prog.feat_shape, prog.n_classes) == (ref.name, ref.feat_shape, ref.n_classes) == (name, (16,), 3)
    assert reference_program(prog) == ref


@pytest.mark.parametrize("name", list(PROGRAM_CASES))
def test_program_loss_and_gradient_match_reference(name):
    """Loss 1e-5 and its gradient 1e-4 on the reference's parameters; metric
    1e-6; the cohort's mapped loss (``torch.func.vmap``) and its gradient
    equal each client's own."""
    prog = PROGRAMS.get(name)()
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
    with torch.no_grad():
        plain = float(lm_loss(forward(tp, prog.cfg, xt)[0], xt, shift=True))
    assert float(got.detach()) == pytest.approx(plain, abs=1e-6)
    for a, b in zip(gg, jax.tree.leaves(gw), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)
    with torch.no_grad():
        assert float(prog.metric(tp, xt, yt)) == pytest.approx(
            float(ref.metric(jp, jnp.asarray(x), jnp.asarray(y))), abs=1e-6)
    stacked = jax.tree.map(lambda a: torch.stack([a.detach(), a.detach() * 0.5]), tp)
    for leaf in jax.tree.leaves(stacked):
        leaf.requires_grad_(True)
    xs = torch.stack([xt, xt.flip(0)])
    cohort = prog.cohort_loss(stacked, xs, torch.stack([yt, yt]))
    grads = torch.autograd.grad(cohort.sum(), jax.tree.leaves(stacked))
    for c in range(2):
        one = jax.tree.map(lambda a: a[c].detach().requires_grad_(True), stacked)
        value = prog.loss(one, xs[c], yt)
        assert float(cohort[c].detach()) == pytest.approx(float(value.detach()), abs=1e-6)
        for a, b in zip(grads, torch.autograd.grad(value, jax.tree.leaves(one)), strict=True):
            np.testing.assert_allclose(a[c].numpy(), b.numpy(), atol=1e-6, rtol=1e-5)


# -- the token populations ----------------------------------------------------------
def _datasets_equal(a, b):
    assert a.x.dtype == b.x.dtype and a.y.dtype == b.y.dtype and a.n_classes == b.n_classes
    assert a.x.tobytes() == np.asarray(b.x).tobytes() and a.y.tobytes() == np.asarray(b.y).tobytes()


@pytest.mark.parametrize("name", list(PROGRAM_CASES))
def test_population_byte_equal_to_reference(name):
    """``build_scenario("lm", model=name)`` eager and lazy: shards, test
    set, topic counts, payload size and (lazy) assignment as the
    reference's."""
    ref = ref_build("lm", model=name, **POP)
    sc = build_scenario("lm", model=name, device="cpu", **POP)
    assert sc.name == ref.name == name and sc.program == PROGRAMS.get(name)()
    assert sc.class_counts.tobytes() == np.asarray(ref.class_counts).tobytes()
    for c, rc in zip(sc.clients, ref.clients, strict=True):
        _datasets_equal(c.shard, rc.shard)
    _datasets_equal(sc.test, ref.test)
    assert sc.model_bits == ref.model_bits
    ref = ref_build("lm", model=name, **LAZY)
    sc = build_scenario("lm", model=name, device="cpu", **LAZY)
    assert sc.name == ref.name == f"lm-stream-{name}" and sc.model_bits == ref.model_bits
    _datasets_equal(sc.test, ref.test)
    assert sc.edge_of.tobytes() == ref.edge_of.tobytes()
    for cid in (0, 31, 59):
        _datasets_equal(sc.source.shard(cid), ref.source.shard(cid))


@pytest.mark.parametrize("name", list(PROGRAM_CASES))
def test_sync_engine_matches_reference(name):
    """Two cloud rounds of the sync engine's device pipeline from the
    reference's initial parameters, held by ``check_run`` to the
    reference's engine."""
    with reference_inits():
        sc = build_scenario("lm", model=name, hparams=CAPPED, device="cpu", **POP)
        ref = ReferencePopulation(sc)
        sc = dataclasses.replace(sc, cost=ref.cost)
        lam = sc.assign("eara-sca", device="cpu").lam
        want = ref.simulate(lam, 2, engine="sync", seed=3)
        got = sc.simulate(lam, 2, engine="sync", seed=3, device="cpu")
    check_run(want, got)
    assert all(np.isfinite(m.mean_local_loss) and m.mean_local_loss > 0 for m in got.history)


def test_lm_mamba_rwkv_mix_matches_reference():
    """``model_mix={"lm": 6, "mamba": 3, "rwkv": 3}`` on the token
    population with the distillation fuse: the reference's name and public
    token pools byte for byte; one round of the sync device pipeline held
    to the reference's engine (accuracy 1e-6, loss 5e-3, parameters 1e-3,
    as the LM/MoE mix), ``final_params`` keyed by program."""
    ref_sc = ref_build("lm", model_mix=MIX, **{k: v for k, v in MIX_POP.items() if k != "hparams"})
    with reference_inits():
        sc = build_scenario("lm", model_mix=MIX, device="cpu", **MIX_POP)
        ref = ReferencePopulation(sc)
        sc = dataclasses.replace(sc, cost=ref.cost)
        assert sc.name == ref_sc.name == "mix(lm+mamba+rwkv)" and sc.is_hetero and sc.distill is not None
        assert len(sc.public) == len(ref_sc.public) == sc.n_edges
        for a, b in zip(sc.public, ref_sc.public):
            _datasets_equal(a, b)
        assert sc.model_bits == ref_sc.model_bits
        lam = sc.assign("eara-sca", device="cpu").lam
        got = sc.simulate(lam, 1, engine="sync", device="cpu")
        assert set(got.final_params) == set(MIX)
        check_run(ref.simulate(lam, 1, engine="sync"), got, loss_tol=5e-3, param_tol=1e-3)
