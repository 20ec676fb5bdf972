"""The port's serving engine against the reference's on the CPU: the same
parameters (carried across) and prompts give the same greedy tokens, for
uniform batches (with the flash branch on and off), ragged batches,
capacity errors and truncation, and hot swaps; plus the launcher's token
count."""
import dataclasses
import re

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402
from repro.serving import ServeEngine as RefServeEngine  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.serving import Request, ServeEngine  # noqa: E402


def _pair(arch, seed=0, **cfg_kw):
    """(reference cfg, port cfg, reference params, port params)."""
    rcfg = dataclasses.replace(ref_smoke(arch), **cfg_kw)
    cfg = dataclasses.replace(get_smoke_config(arch), **cfg_kw)
    jp = ref_init_params(jax.random.PRNGKey(seed), rcfg)
    return rcfg, cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _prompts(vocab, lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _serve(engine, prompts, new, request_cls):
    return [r.out for r in engine.run([request_cls(p.copy(), max_new_tokens=new) for p in prompts])]


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
@pytest.mark.parametrize("arch", ["qwen3-14b", "starcoder2-3b"])
def test_uniform_batch_matches_reference(arch, use_flash):
    rcfg, cfg, jp, tp = _pair(arch, use_flash=use_flash)
    prompts = _prompts(cfg.vocab_size, [40, 40, 40])  # past starcoder2's window of 32
    ref = _serve(RefServeEngine(rcfg, params=jp, max_seq=48), prompts, 6, RefRequest)
    out = _serve(ServeEngine(cfg, params=tp, max_seq=48, device="cpu"), prompts, 6, Request)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "phi3-mini-3.8b"])
def test_ragged_batch_matches_reference_and_solo(arch):
    rcfg, cfg, jp, tp = _pair(arch, use_flash=True)
    prompts = _prompts(cfg.vocab_size, [5, 9, 9, 3])
    ref = _serve(RefServeEngine(rcfg, params=jp, max_seq=48), prompts, 6, RefRequest)
    eng = ServeEngine(cfg, params=tp, max_seq=48, device="cpu")
    reset_launch_counts()
    batched = _serve(eng, prompts, 6, Request)
    for i, (a, b) in enumerate(zip(batched, ref)):
        np.testing.assert_array_equal(a, b, err_msg=f"row {i}")
        np.testing.assert_array_equal(a, _serve(eng, prompts[i:i + 1], 6, Request)[0])
    assert launch_counts()["flash_attention"] == 0  # the CPU runs the plain version


def test_capacity_errors_and_truncation_match_reference():
    rcfg, cfg, jp, tp = _pair("phi3-mini-3.8b")
    prompt = _prompts(cfg.vocab_size, [8], seed=2)[0]
    for make, req in ((lambda **kw: RefServeEngine(rcfg, params=jp, max_seq=16, **kw), RefRequest),
                      (lambda **kw: ServeEngine(cfg, params=tp, max_seq=16, device="cpu", **kw), Request)):
        eng = make()
        full = eng.run([req(prompt.copy(), max_new_tokens=8)])[0]  # 8 + 8 == 16 fits
        assert full.out.shape == (8,) and not full.truncated
        with pytest.raises(ValueError, match=r"request 0: prompt \(8\) \+ max_new_tokens \(9\) exceeds max_seq=16"):
            eng.run([req(prompt.copy(), max_new_tokens=9)])
        # 3 + 9 would fit alone, but a ragged batch starts every row at max(len) = 8
        with pytest.raises(ValueError, match=r"request 1: prompt \(3\) .* share buffer slots"):
            eng.run([req(prompt.copy(), max_new_tokens=8), req(prompt[:3].copy(), max_new_tokens=9)])
        with pytest.raises(ValueError, match="exceeds max_seq"):
            eng.run([req(np.zeros(17, np.int32), max_new_tokens=1)])
        r = make(on_overflow="truncate").run([req(prompt.copy(), max_new_tokens=9)])[0]
        assert r.truncated and r.out.shape == (8,)
        np.testing.assert_array_equal(r.out, full.out)
    with pytest.raises(ValueError, match="on_overflow"):
        ServeEngine(cfg, params=tp, device="cpu", on_overflow="drop")


def test_hot_swap_matches_reference():
    rcfg, cfg, ja, ta = _pair("qwen1.5-4b", seed=0)
    _, _, jb, tb = _pair("qwen1.5-4b", seed=1)
    prompts = [np.arange(1, 9, dtype=np.int32)]
    ref = RefServeEngine(rcfg, params=ja, max_seq=32)
    eng = ServeEngine(cfg, params=ta, max_seq=32, device="cpu")
    outs = []
    for jp, tp, version in ((ja, ta, None), (jb, tb, "r1"), (ja, ta, "r2")):
        if version:
            ref.swap(jp, version=version)
            eng.swap(tp, version=version)
        assert eng.version == version
        outs.append(_serve(eng, prompts, 5, Request)[0])
        np.testing.assert_array_equal(outs[-1], _serve(ref, prompts, 5, RefRequest)[0])
    np.testing.assert_array_equal(outs[0], outs[2])  # A -> B -> A replays A


def test_engine_draws_params_from_seed():
    cfg = get_smoke_config("qwen3-14b")
    prompts = _prompts(cfg.vocab_size, [6, 6])
    a = _serve(ServeEngine(cfg, max_seq=16, seed=3, device="cpu"), prompts, 4, Request)
    b = _serve(ServeEngine(cfg, max_seq=16, seed=3, device="cpu"), prompts, 4, Request)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
        assert x.shape == (4,) and x.max() < cfg.vocab_size


def test_serve_launcher_token_count(capsys):
    from repro_torch.launch import serve as serve_launch

    serve_launch.main(["--arch", "qwen1.5-4b", "--batch", "2", "--prompt-len", "4", "--tokens", "1",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    m = re.search(r"tokens=(\d+), ([\d.]+) tok/s \(CPU\)", out)
    assert m, out
    assert int(m.group(1)) == 2  # exactly one emitted token per request
    assert float(m.group(2)) > 0.0
    assert "flops" not in out  # --tokens 1 runs no decode step, so no decode-step cost line
