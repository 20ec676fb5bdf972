"""The encoder-decoder family (whisper) and the serve spans' analytic cost,
against the reference on the CPU.

On the reference's parameters carried across (``repro_torch.convert``)
and the same numpy-drawn tokens and frame embeddings, at whisper-tiny's
smoke config in fp32: ``encode``, ``forward``, ``prefill`` (its cache, the
cross K and V included), ``decode_step`` and ``init_cache`` (1e-5); prefill
plus decode equals ``forward`` (the reference's
``tests/test_consistency.py`` check); ``ServeEngine`` gives the
reference's greedy tokens for uniform and ragged batches, and each ragged
row equals its request served alone.  The ``prefill`` and ``decode``
spans carry the reference's FLOPs, and counting them advances no cache.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402
from repro.serving import ServeEngine as RefServeEngine  # noqa: E402
from repro.telemetry import Telemetry as RefTelemetry  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serving import Request, ServeEngine  # noqa: E402
from repro_torch.telemetry import Telemetry  # noqa: E402

ARCH = "whisper-tiny"
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def whisper():
    rcfg, cfg = ref_smoke(ARCH), get_smoke_config(ARCH)
    jp = ref_tf.init_params(jax.random.PRNGKey(0), rcfg)
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((3, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return rcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp)), emb


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x, np.float32)


def _trees_close(want, got):
    assert jax.tree.structure(want) == jax.tree.structure(params_to_numpy(got))
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(params_to_numpy(got)), strict=True):
        np.testing.assert_allclose(b, np.asarray(a), **TOL)


def test_encode_forward_prefill_decode_match_reference(whisper):
    rcfg, cfg, jp, tp, emb = whisper
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 12)).astype(np.int32)
    je, te = jnp.asarray(emb), torch.as_tensor(emb)
    np.testing.assert_allclose(_np(tf.encode(tp, cfg, te)), np.asarray(ref_tf.encode(jp, rcfg, je)), **TOL)
    want = ref_tf.forward(jp, rcfg, jnp.asarray(toks), enc_embeds=je)[0]
    got = tf.forward(tp, cfg, torch.as_tensor(toks), enc_embeds=te)[0]
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    lw, cw = ref_tf.prefill(jp, rcfg, jnp.asarray(toks), max_seq=20, enc_embeds=je)
    lg, cg = tf.prefill(tp, cfg, torch.as_tensor(toks), max_seq=20, enc_embeds=te)
    np.testing.assert_allclose(_np(lg), np.asarray(lw), **TOL)
    _trees_close(cw, cg)  # k, v and each decoder layer's cross_k, cross_v
    cross_before = [c["cross_k"].clone() for c in cg]
    tok = np.array(jnp.argmax(lw[:, -1], -1))[:, None]
    pos = np.full(3, 12, np.int32)
    dw, cw = ref_tf.decode_step(jp, rcfg, jnp.asarray(tok), cw, jnp.asarray(pos))
    dg, cg = tf.decode_step(tp, cfg, torch.as_tensor(tok, dtype=torch.int64), cg, torch.as_tensor(pos))
    np.testing.assert_allclose(_np(dg), np.asarray(dw), **TOL)
    _trees_close(cw, cg)
    for c, before in zip(cg, cross_before):  # decode advances k and v only
        assert torch.equal(c["cross_k"], before)
    _trees_close(ref_tf.init_cache(rcfg, 3, 20, enc_embeds=je, params=jp),
                 tf.init_cache(cfg, 3, 20, enc_embeds=te, params=tp, device="cpu"))
    with pytest.raises(ValueError, match="enc_embeds"):
        tf.forward(tp, cfg, torch.as_tensor(toks))


def test_prefill_plus_decode_equals_forward(whisper):
    """Decoding token by token from a prefill of the first half gives the
    full forward's logits at every later position (1e-4, the reference's
    consistency tolerance)."""
    _, cfg, _, tp, emb = whisper
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 10)))
    te = torch.as_tensor(emb[:2])
    full = tf.forward(tp, cfg, toks, enc_embeds=te)[0]
    logits, cache = tf.prefill(tp, cfg, toks[:, :5], max_seq=10, enc_embeds=te)
    np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, 4]), atol=1e-4, rtol=1e-4)
    for t in range(5, 10):
        logits, cache = tf.decode_step(tp, cfg, toks[:, t:t + 1], cache, torch.full((2,), t))
        np.testing.assert_allclose(_np(logits[:, 0]), _np(full[:, t]), atol=1e-4, rtol=1e-4)


def test_serving_matches_reference_uniform_ragged_and_solo(whisper):
    rcfg, cfg, jp, tp, emb = whisper
    rng = np.random.default_rng(3)
    eng = ServeEngine(cfg, params=tp, max_seq=32, device="cpu")
    ref = RefServeEngine(rcfg, params=jp, max_seq=32)
    for lens in ([9, 9, 9], [9, 4, 7]):
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
        want = [r.out for r in ref.run([RefRequest(p.copy(), max_new_tokens=6) for p in prompts],
                                       enc_embeds=jnp.asarray(emb))]
        got = [r.out for r in eng.run([Request(p.copy(), max_new_tokens=6) for p in prompts], enc_embeds=emb)]
        for i, (a, b) in enumerate(zip(got, want, strict=True)):
            np.testing.assert_array_equal(a, b, err_msg=f"lens {lens} row {i}")
        if lens[0] != lens[1]:
            for i, p in enumerate(prompts):
                solo = eng.run([Request(p.copy(), max_new_tokens=6)], enc_embeds=torch.as_tensor(emb[i:i + 1]))
                np.testing.assert_array_equal(got[i], solo[0].out)
    with pytest.raises(ValueError, match="enc_embeds"):
        eng.run([Request(prompts[0].copy(), max_new_tokens=2)])


@pytest.mark.parametrize("arch", ["qwen3-14b", ARCH])
def test_serve_spans_carry_reference_flops(arch):
    """The ``prefill`` and ``decode`` spans carry ``flops`` equal to the
    reference's HLO count at the smoke config in fp32, and ``bytes_moved``
    (eager execution writes every intermediate, so not the reference's)."""
    rcfg, cfg = ref_smoke(arch), get_smoke_config(arch)
    jp = ref_tf.init_params(jax.random.PRNGKey(0), rcfg)
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    kw = {}
    if cfg.family == "encdec":
        kw["enc_embeds"] = rng.standard_normal((2, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    rtel, tel = RefTelemetry(), Telemetry()
    RefServeEngine(rcfg, params=jp, max_seq=16, telemetry=rtel).run(
        [RefRequest(p, 3) for p in prompts], **{k: jnp.asarray(v) for k, v in kw.items()})
    ServeEngine(cfg, params=params_from_numpy(jax.tree.map(np.asarray, jp)), max_seq=16, telemetry=tel,
                device="cpu").run([Request(p, 3) for p in prompts], **kw)
    for name in ("prefill", "decode"):
        want = [s for s in rtel.tracer.spans if s.name == name][-1].attrs
        got = [s for s in tel.tracer.spans if s.name == name][-1].attrs
        assert got["flops"] == want["flops"] > 0, name
        assert got["bytes_moved"] > 0, name


def test_serve_cost_leaves_the_cache_alone():
    """Counting the decode step runs it on meta copies: the recurrent
    state the real step advances in place is untouched, so a run with
    telemetry gives the tokens of a run without, and the spans carry the
    cost."""
    cfg = get_smoke_config("rwkv6-7b")
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    outs = []
    for tel in (None, Telemetry()):
        eng = ServeEngine(cfg, max_seq=16, seed=1, telemetry=tel, device="cpu")
        outs.append([r.out for r in eng.run([Request(p, 5) for p in prompts])])
    for a, b in zip(*outs, strict=True):
        np.testing.assert_array_equal(a, b)
    assert all("flops" in s.attrs for s in tel.tracer.spans if s.name in ("prefill", "decode"))


def test_serve_launcher_draws_frame_embeddings(capsys):
    from repro_torch.launch import serve as serve_launch

    serve_launch.main(["--arch", ARCH, "--batch", "2", "--prompt-len", "4", "--tokens", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "whisper-tiny-smoke: prefill" in out and "tokens=6" in out
    assert "decode step:" in out and "flops" in out


def test_bf16_tree_serves(whisper):
    """The bf16 smoke tree (the full config's dtype) serves through the
    engine: finite logits, tokens in range."""
    _, cfg, _, _, emb = whisper
    bcfg = dataclasses.replace(cfg, dtype="bfloat16")
    eng = ServeEngine(bcfg, max_seq=16, seed=0, device="cpu")
    reqs = eng.run([Request(np.arange(5, dtype=np.int32), 4)], enc_embeds=torch.as_tensor(emb[:1]))
    assert reqs[0].out.shape == (4,) and reqs[0].out.max() < cfg.vocab_size
