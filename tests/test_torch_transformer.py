"""The port's sequence-model layers against the reference on the CPU: norms,
rope, the MLP activations, and prefill + decode logits and caches of the
dense smoke configs on carried-across parameters (fp32, 1e-5)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import modules as ref_modules  # noqa: E402
from repro.models.mlp import mlp as ref_mlp  # noqa: E402
from repro.models.transformer import decode_step as ref_decode_step  # noqa: E402
from repro.models.transformer import forward as ref_forward  # noqa: E402
from repro.models.transformer import init_params as ref_init_params  # noqa: E402
from repro.models.transformer import prefill as ref_prefill  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config, list_archs  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models import modules  # noqa: E402
from repro_torch.models.mlp import mlp  # noqa: E402
from repro_torch.models.transformer import decode_step, forward, prefill  # noqa: E402

DENSE = ["qwen3-14b", "starcoder2-3b", "phi3-mini-3.8b", "qwen1.5-4b"]
TOL = dict(atol=1e-5, rtol=1e-5)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x, np.float32)


def _carry(jax_tree):
    return params_from_numpy(jax.tree.map(np.asarray, jax_tree))


@pytest.fixture(scope="module", params=DENSE)
def model(request):
    rcfg = ref_smoke(request.param)
    jparams = ref_init_params(jax.random.PRNGKey(0), rcfg)
    return rcfg, get_smoke_config(request.param), jparams, _carry(jparams)


def test_registry_matches_reference():
    from repro.configs import ARCH_IDS as REF_IDS
    from repro.configs import get_config as ref_get

    assert ARCH_IDS == REF_IDS and list_archs() == sorted(REF_IDS)
    for arch in ARCH_IDS:
        for mine, ref in ((get_config(arch), ref_get(arch)), (get_smoke_config(arch), ref_smoke(arch))):
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
            assert mine.param_dtype == getattr(torch, ref.dtype)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "rwkv6-7b", "jamba-1.5-large-398b", "whisper-tiny"])
def test_unported_families_raise(arch):
    from repro_torch.serving import ServeEngine

    cfg = get_smoke_config(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServeEngine(cfg, params={}, device="cpu")


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms(kind):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(48).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = rng.standard_normal(48).astype(np.float32)
    ref = ref_modules.apply_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x), 1e-5)
    out = modules.apply_norm(params_from_numpy(p), torch.tensor(x), 1e-5)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


def test_rope():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 7))
    np.testing.assert_array_equal(modules.rope_frequencies(16, 1e6), ref_modules.rope_frequencies(16, 1e6))
    ref = ref_modules.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    out = modules.apply_rope(torch.tensor(x), torch.tensor(pos), 1e6)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


@pytest.mark.parametrize("arch", ["starcoder2-3b", "qwen3-14b"], ids=["gelu-tanh", "swiglu"])
def test_mlp(arch):
    from repro.models.mlp import mlp_init as ref_mlp_init

    rcfg, cfg = ref_smoke(arch), get_smoke_config(arch)
    jp = ref_mlp_init(jax.random.PRNGKey(3), rcfg)
    x = np.random.default_rng(2).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    ref = ref_mlp(jp, rcfg, jnp.asarray(x))
    out = mlp(_carry(jp), cfg, torch.tensor(x))
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
def test_prefill_and_decode_match_reference(model, use_flash):
    rcfg, cfg, jparams, params = model
    rcfg = dataclasses.replace(rcfg, use_flash=use_flash)
    cfg = dataclasses.replace(cfg, use_flash=use_flash)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)  # starcoder2's window 32 bites
    max_seq = 44
    ref_logits, ref_cache = ref_prefill(jparams, rcfg, jnp.asarray(toks), max_seq=max_seq)
    logits, cache = prefill(params, cfg, torch.tensor(toks, dtype=torch.int64), max_seq=max_seq)
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (2, 1, cfg.vocab_size)
    np.testing.assert_allclose(_np(logits), _np(ref_logits), **TOL)
    for mine, ref in zip(cache, ref_cache):
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(mine[key]), _np(ref[key]), **TOL)
    tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    pos = np.array([40, 40], np.int32)
    for step in range(2):
        ref_logits, ref_cache = ref_decode_step(jparams, rcfg, jnp.asarray(tok), ref_cache, jnp.asarray(pos + step))
        logits, cache = decode_step(params, cfg, torch.tensor(tok, dtype=torch.int64), cache,
                                    torch.tensor(pos + step, dtype=torch.int64))
        np.testing.assert_allclose(_np(logits), _np(ref_logits), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(cache[0][key]), _np(ref_cache[0][key]), **TOL)


def test_forward_matches_reference(model):
    rcfg, cfg, jparams, params = model
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    ref_logits, _ = ref_forward(jparams, rcfg, jnp.asarray(toks))
    logits, aux = forward(params, cfg, torch.tensor(toks, dtype=torch.int64))
    np.testing.assert_allclose(_np(logits), _np(ref_logits), **TOL)
    assert float(aux["moe_aux"]) == 0.0


def test_blockwise_prefill_above_1024_tokens():
    """Past 1024 tokens the non-flash prefill takes the blockwise branch."""
    rcfg = dataclasses.replace(ref_smoke("starcoder2-3b"), n_layers=1, max_seq=2048)
    cfg = dataclasses.replace(get_smoke_config("starcoder2-3b"), n_layers=1, max_seq=2048)
    jparams = ref_init_params(jax.random.PRNGKey(1), rcfg)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (1, 1536)).astype(np.int32)
    ref_logits, _ = ref_prefill(jparams, rcfg, jnp.asarray(toks))
    logits, _ = prefill(_carry(jparams), cfg, torch.tensor(toks, dtype=torch.int64))
    np.testing.assert_allclose(_np(logits), _np(ref_logits), **TOL)


def test_bf16_params_round_trip_bit_identical():
    """A bf16 reference tree (tuple of stacked blocks) crosses and returns
    bit for bit."""
    cfg = dataclasses.replace(ref_smoke("qwen3-14b"), dtype="bfloat16")
    jparams = ref_init_params(jax.random.PRNGKey(2), cfg)
    tree = jax.tree.map(np.asarray, jparams)
    carried = params_from_numpy(tree)
    assert isinstance(carried["blocks"], tuple)
    assert carried["blocks"][0]["mixer"]["wq"]["w"].dtype == torch.bfloat16
    back = params_to_numpy(carried)
    assert isinstance(back["blocks"], tuple)
    leaves, ref_leaves = jax.tree.leaves(back), jax.tree.leaves(tree)
    assert len(leaves) == len(ref_leaves)
    for a, b in zip(leaves, ref_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint16), b.view(np.uint16))


def test_decode_attention_matches_reference(model):
    """The public decode pieces (the engine fuses them into one projection)
    on a left-padded layout: slot > position, pad slots masked."""
    from repro.models.attention import decode_attention as ref_decode_attention
    from repro.models.attention import project_decode_kv as ref_project_decode_kv
    from repro_torch.models.attention import decode_attention, project_decode_kv

    rcfg, cfg, jparams, params = model
    rng = np.random.default_rng(7)
    b, s = 2, 40
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((b, s, cfg.n_kv_heads, cfg.d_head)).astype(np.float32)
    cv = rng.standard_normal((b, s, cfg.n_kv_heads, cfg.d_head)).astype(np.float32)
    position, slot = np.array([5, 38], np.int32), np.array([38, 38], np.int32)  # starcoder2's window 32 bites
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][0]["mixer"])
    tp = {k: ({kk: vv[0] for kk, vv in v.items()}) for k, v in params["blocks"][0]["mixer"].items()}
    t = {n: torch.tensor(a) for n, a in (("x", x), ("ck", ck), ("cv", cv))}
    tpos, tslot = torch.tensor(position, dtype=torch.int64), torch.tensor(slot, dtype=torch.int64)
    for mine, ref in zip(project_decode_kv(tp, cfg, t["x"], tpos),
                         ref_project_decode_kv(jp, rcfg, jnp.asarray(x), jnp.asarray(position))):
        np.testing.assert_allclose(_np(mine), _np(ref), **TOL)
    ref = ref_decode_attention(jp, rcfg, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(position),
                               window=rcfg.sliding_window, slot=jnp.asarray(slot))
    out = decode_attention(tp, cfg, t["x"], t["ck"], t["cv"], tpos, window=cfg.sliding_window, slot=tslot)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)
