"""LM training in the port against the reference on the CPU: the
optimizers (1e-6), the in-place Adam update (bit for bit against the
functional one), ``make_train_step`` on the dense, MoE and whisper smoke
configs (gradients 1e-5; parameters after 2 Adam steps 1e-4, see
``test_train_step_matches_reference``), checkpoints crossing between the
packages both ways, the ``--arch`` launcher, ``optimal_ilp``, and the
kernels' no-gradient guard."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.training as ref_training  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.core import optimal_ilp as ref_optimal_ilp  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro_torch import training  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import optimal_ilp  # noqa: E402
from repro_torch.kernels import adam as adam_kernel  # noqa: E402
from repro_torch.kernels import flash_attention, launch_counts, topk_gating  # noqa: E402
from repro_torch.training import optimizers  # noqa: E402


def _tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.standard_normal((5, 3)).astype(dtype)}, "b": (rng.standard_normal(7).astype(dtype),)}


def _carry(tree):
    return params_from_numpy(tree)


def _close(want, got, tol):
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(params_to_numpy(got)), strict=True):
        np.testing.assert_allclose(np.asarray(b, np.float32), np.asarray(a, np.float32), atol=tol, rtol=tol)


# -- optimizers ---------------------------------------------------------------
OPTIMIZERS = {
    "adam": lambda m: m.adam(1e-2),
    "adam_wd_schedule_bf16_moments": lambda m: m.adam(
        1e-2, weight_decay=0.05, schedule=m.cosine_schedule(10, warmup=2),
        moment_dtype=jnp.bfloat16 if m is ref_training else torch.bfloat16),
    "adamw": lambda m: m.adamw(),
    "sgd_momentum": lambda m: m.sgd(0.1, momentum=0.9),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizers_match_reference(name):
    """Three updates on the same trees (1e-6), and the bf16 moments kept in
    bf16."""
    ref_opt, opt = OPTIMIZERS[name](ref_training), OPTIMIZERS[name](training)
    jp, tp = jax.tree.map(jnp.asarray, _tree(0)), _carry(_tree(0))
    js, ts = ref_opt.init(jp), opt.init(tp)
    for step in range(3):
        g = _tree(step + 1)
        jp, js = ref_opt.update(jp, jax.tree.map(jnp.asarray, g), js, jnp.asarray(step))
        tp, ts = opt.update(tp, _carry(g), ts, step)
        _close(jp, tp, 1e-6)
        _close(js, ts, 1e-6)
    if "bf16" in name:
        assert {t.dtype for t in jax.tree.leaves(ts)} == {torch.bfloat16}


def test_schedule_and_clip_match_reference():
    ref_fn = ref_training.cosine_schedule(50, warmup=5, floor=0.2)
    fn = training.cosine_schedule(50, warmup=5, floor=0.2)
    for step in (0, 1, 4, 5, 17, 49, 50, 80):
        assert float(fn(step)) == pytest.approx(float(ref_fn(jnp.asarray(step))), abs=1e-6)
    for max_norm in (0.5, 100.0):
        want, wn = ref_training.clip_by_global_norm(jax.tree.map(jnp.asarray, _tree(3)), max_norm)
        got, gn = training.clip_by_global_norm(_carry(_tree(3)), max_norm)
        assert float(gn) == pytest.approx(float(wn), abs=1e-6)
        _close(want, got, 1e-6)
        inplace = _carry(_tree(3))
        assert torch.equal(optimizers.clip_by_global_norm_(inplace, max_norm), gn)
        for a, b in zip(jax.tree.leaves(inplace), jax.tree.leaves(got), strict=True):
            assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [{}, {"weight_decay": 0.1, "schedule": "cosine", "moment_dtype": torch.bfloat16}],
                         ids=["default", "wd_schedule_bf16_moments"])
@pytest.mark.parametrize("param_dtype", [torch.float32, torch.bfloat16])
def test_inplace_update_equals_functional(kw, param_dtype, monkeypatch):
    """``update_`` writes exactly what ``update`` returns, bit for bit,
    into the parameters' and moments' storage, also when a leaf spans
    several slices."""
    monkeypatch.setattr(adam_kernel, "_SLICE", 4)
    kw = dict(kw, schedule=training.cosine_schedule(6, warmup=1)) if kw else kw
    opt = training.adam(3e-2, **kw)
    params = jax.tree.map(lambda t: t.to(param_dtype), _carry(_tree(4)))
    functional, inplace = params, jax.tree.map(torch.clone, params)
    fs, ist = opt.init(functional), opt.init(inplace)
    storage = [t.data_ptr() for t in jax.tree.leaves((inplace, ist))]
    for step in range(3):
        g = jax.tree.map(lambda t: t.to(param_dtype), _carry(_tree(10 + step)))
        functional, fs = opt.update(functional, g, fs, step)
        opt.update_(inplace, g, ist, step)
        for a, b in zip(jax.tree.leaves((functional, fs)), jax.tree.leaves((inplace, ist)), strict=True):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert storage == [t.data_ptr() for t in jax.tree.leaves((inplace, ist))]


# -- the train step -------------------------------------------------------------
def _batches(cfg, n=2, b=4, s=16, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
        batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
        if cfg.family == "encdec":
            batch["enc_embeds"] = rng.standard_normal((b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
        out.append(batch)
    return out


def _torch_batch(batch):
    return {k: torch.as_tensor(v.astype(np.int64) if v.dtype == np.int32 else v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ["qwen3-14b", "granite-moe-3b-a800m", "whisper-tiny"])
def test_train_step_matches_reference(arch):
    """2 Adam steps with ``grad_accum`` 2, ``remat`` off and on, against
    the reference's (whose ``remat`` moves no value); for the dense config
    also ``grad_accum`` 1 and the gradients alone.  The gradients agree at
    2e-7 (held at 1e-5) and the metrics at 1e-5; the parameters at 1e-4:
    Adam's first steps move each parameter by ~lr * g / |g|, which turns
    2e-7 gradient differences on near-zero gradients into ~6e-5.
    ``remat`` gives the same bits, and ``grad_accum`` 2 stays within the
    reference's own 5e-3 of ``grad_accum`` 1
    (``tests/test_models.py::test_grad_accum_equivalence``)."""
    rcfg, cfg = ref_smoke(arch), get_smoke_config(arch)
    jp = ref_init_params(jax.random.PRNGKey(0), rcfg)
    batches = _batches(cfg)
    dense = cfg.family == "dense"
    if dense:
        gw, _ = ref_training.make_grad_step(rcfg)(jp, jax.tree.map(jnp.asarray, batches[0]))
        gg, _ = training.make_grad_step(cfg)(_carry(jax.tree.map(np.asarray, jp)), _torch_batch(batches[0]))
        _close(gw, gg, 1e-5)
    runs = {}
    for ga in ((1, 2) if dense else (2,)):
        ref_opt = ref_training.adam(1e-3)
        step = jax.jit(ref_training.make_train_step(rcfg, ref_opt, grad_accum=ga))
        st = ref_training.init_train_state(jp, ref_opt)
        for b in batches:
            st, rm = step(st, jax.tree.map(jnp.asarray, b))
        for remat in (False, True):
            opt = training.adam(1e-3)
            pstep = training.make_train_step(cfg, opt, grad_accum=ga, remat=remat)
            ps = training.init_train_state(_carry(jax.tree.map(np.asarray, jp)), opt)
            for b in batches:
                ps, pm = pstep(ps, _torch_batch(b))
            assert ps.step == 2
            _close(st.params, ps.params, 1e-4)
            for k in rm:
                assert float(pm[k]) == pytest.approx(float(rm[k]), abs=1e-5), (ga, remat, k)
            runs[ga, remat] = ps.params
        for a, b in zip(jax.tree.leaves(runs[ga, False]), jax.tree.leaves(runs[ga, True]), strict=True):
            assert torch.equal(a, b)
    if dense:
        d = max(float((a - b).abs().max())
                for a, b in zip(jax.tree.leaves(runs[1, False]), jax.tree.leaves(runs[2, False])))
        assert d < 5e-3


def test_train_step_refuses_a_mesh_and_serve_step_decodes():
    """Given a spec tree (the sharded step), the step refuses a state whose
    parameters are not DTensors laid out on a mesh, rather than train them
    unsharded (``tests/test_torch_sharded_train.py`` runs it on a mesh)."""
    cfg = get_smoke_config("qwen3-14b")
    params = training.init_train_state(
        __import__("repro_torch.models", fromlist=["init_params"]).init_params(torch.Generator().manual_seed(0), cfg),
        training.sgd(0.1)).params
    step = training.make_train_step(cfg, training.adam(), param_pspec={})
    with pytest.raises(ValueError, match="DTensor"):
        step(training.init_train_state(params, training.adam()), _torch_batch(_batches(cfg)[0]))
    from repro_torch.models.transformer import decode_step, prefill

    toks = torch.arange(6)[None] % cfg.vocab_size
    _, cache = prefill(params, cfg, toks, max_seq=8)
    ref_cache = jax.tree.map(torch.clone, cache)
    got, _ = training.make_serve_step(cfg)(params, cache, toks[:, -1:], torch.tensor([6]))
    want, _ = decode_step(params, cfg, toks[:, -1:], ref_cache, torch.tensor([6]))
    assert torch.equal(got, want)


# -- checkpoints ------------------------------------------------------------------
def test_checkpoints_cross_both_ways(tmp_path):
    """A reference checkpoint loads into the port and a port checkpoint into
    the reference, fp32 bit for bit, with equal manifests; a bf16 leaf is
    written as the reference writes it (``'<V2'`` bit patterns) and the port
    loads the reference's bytes back exactly (the reference's own loader
    has no cast from ``V2``).  Missing keys raise ``KeyError``, other
    shapes ``ValueError``."""
    import ml_dtypes

    jp = ref_init_params(jax.random.PRNGKey(0), ref_smoke("whisper-tiny"))
    tp = _carry(jax.tree.map(np.asarray, jp))
    ref_path, port_path = str(tmp_path / "ref" / "ck.npz"), str(tmp_path / "port" / "ck.npz")
    ref_training.save_checkpoint(ref_path, jp, step=3, extra={"arch": "whisper"})
    training.save_checkpoint(port_path, tp, step=3, extra={"arch": "whisper"})
    assert json.load(open(ref_path + ".json")) == json.load(open(port_path + ".json"))
    zeros_t = jax.tree.map(torch.zeros_like, tp)
    for path in (ref_path, port_path):
        got = training.load_checkpoint(path, zeros_t)
        for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(got), strict=True):
            assert torch.equal(a, b)
        back = ref_training.load_checkpoint(path, jax.tree.map(jnp.zeros_like, jp))
        for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back), strict=True):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    bf = {"emb": (np.arange(12, dtype=np.float32).reshape(3, 4) / 7).astype(ml_dtypes.bfloat16),
          "blocks": ({"w": np.full((2, 2), 3, ml_dtypes.bfloat16)},)}
    ref_training.save_checkpoint(ref_path, bf)
    training.save_checkpoint(port_path, params_from_numpy(bf))
    assert json.load(open(ref_path + ".json")) == json.load(open(port_path + ".json"))
    with np.load(ref_path) as r, np.load(port_path) as p:
        for k in r.files:
            assert r[k].dtype == p[k].dtype == np.dtype("V2") and r[k].tobytes() == p[k].tobytes()
    like = jax.tree.map(torch.zeros_like, params_from_numpy(bf))
    for a, b in zip(jax.tree.leaves(params_from_numpy(bf)), jax.tree.leaves(training.load_checkpoint(ref_path, like))):
        assert b.dtype == torch.bfloat16 and torch.equal(a, b)
    with pytest.raises(KeyError, match="missing"):
        training.load_checkpoint(ref_path, {"other": torch.zeros(2)})
    with pytest.raises(ValueError, match="shape"):
        training.load_checkpoint(ref_path, dict(like, emb=torch.zeros((4, 3), dtype=torch.bfloat16)))


# -- the launcher -------------------------------------------------------------------
def test_run_lm_trains_and_checkpoints(tmp_path, capsys):
    """``launch.train --arch`` on the CPU: 2 steps of the qwen3-14b smoke
    config, losses near ln(V) at random init, the first span's analytic
    cost, and a checkpoint that loads into the model's tree."""
    from repro_torch.launch import train
    from repro_torch.models import init_params

    ck, tel = str(tmp_path / "lm.npz"), tmp_path / "tel"
    train.main(["--arch", "qwen3-14b", "--steps", "2", "--batch", "2", "--seq", "16", "--device", "cpu",
                "--checkpoint", ck, "--telemetry", str(tel)])
    out = capsys.readouterr().out
    losses = [float(line.split("loss=")[1].split()[0]) for line in out.splitlines() if line.startswith("step")]
    cfg = get_smoke_config("qwen3-14b")
    assert len(losses) == 2 and all(abs(x - np.log(cfg.vocab_size)) < 0.5 for x in losses)
    spans = [json.loads(line) for line in open(tel / "trace.jsonl")]
    first = [s for s in spans if s["name"] == "train_step"][0]
    assert first["attrs"]["flops"] > 0
    like = init_params(torch.Generator().manual_seed(9), cfg)
    loaded = training.load_checkpoint(ck, like)
    assert json.load(open(ck + ".json"))["step"] == 2
    assert all(torch.isfinite(t).all() for t in jax.tree.leaves(loaded))


# -- the assignment oracle -----------------------------------------------------------
@pytest.mark.parametrize("objective", ["kld", "l1"])
def test_optimal_ilp_matches_reference(objective):
    rng = np.random.default_rng(3)
    for m, n, k in ((6, 2, 2), (5, 3, 3)):
        cc = np.zeros((m, k))
        for i in range(m):
            cc[i, i % k] = 1000
            cc[i, (i + 1) % k] = rng.integers(0, 100)
        feas = rng.random((m, n)) < 0.8
        feas[np.arange(m), rng.integers(0, n, m)] = True
        want, got = ref_optimal_ilp(cc, feas, objective), optimal_ilp(cc, feas, objective)
        np.testing.assert_array_equal(got.lam, want.lam)
        assert got.kld_total == pytest.approx(want.kld_total, abs=1e-6)
    with pytest.raises(ValueError, match="M too large"):
        optimal_ilp(np.ones((13, 2)), np.ones((13, 2), bool))


# -- the kernels define no gradient ------------------------------------------------------
def test_kernels_refuse_autograd_and_take_meta():
    """Under autograd, an input that requires a gradient makes
    ``flash_attention`` and ``topk_gating`` raise on the CPU, as on the card
    (where the launch would return a detached output); without grad, or
    under ``no_grad``, they run; meta tensors take their plain versions and
    count no launch."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 8, 2, 16), generator=g) for _ in range(3))
    logits = torch.randn((5, 8), generator=g)
    with pytest.raises(RuntimeError, match="no gradient"):
        flash_attention(q.requires_grad_(True), k, v)
    with pytest.raises(RuntimeError, match="no gradient"):
        topk_gating(logits.requires_grad_(True), 2)
    with torch.no_grad():
        assert flash_attention(q, k, v).shape == q.shape and topk_gating(logits, 2).shape == logits.shape
    cfg = dataclasses.replace(get_smoke_config("qwen3-14b"), use_flash=True)
    from repro_torch.models import init_params
    from repro_torch.models.transformer import forward

    params = init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no gradient"):
        training.make_grad_step(cfg)(params, _torch_batch(_batches(cfg, n=1)[0]))
    before = launch_counts()
    meta = [t.detach().to("meta") for t in (q, k, v, logits)]
    assert flash_attention(*meta[:3]).device.type == "meta" and topk_gating(meta[3], 2).device.type == "meta"
    assert forward(jax.tree.map(lambda t: t.to("meta"), params), cfg, torch.zeros((1, 4), dtype=torch.int64,
                                                                                     device="meta"))[0].is_meta
    assert launch_counts() == before
