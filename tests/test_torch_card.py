"""Every kernel of the port against its plain version on a CUDA card.

These tests need the card (marker ``cuda``) and skip without one, deciding
in a fixture.  They import neither JAX nor the reference package (the
reference's agreement with the plain versions is held by the CPU tests),
so they run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest tests/test_torch_card.py -m cuda -q
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import (  # noqa: E402
    flash_attention,
    flash_attention_ref,
    hier_aggregate,
    hier_aggregate_ref,
    hier_segment_aggregate,
    hier_segment_aggregate_ref,
    launch_counts,
    reset_launch_counts,
    topk_gating,
    topk_gating_ref,
)
from torch_segment_replay import segment_kernel_replay  # noqa: E402

pytestmark = pytest.mark.cuda

AGG_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
RAGGED_CASES = [
    # empty segment (2), single-client segment (4)
    (np.array([0, 0, 0, 1, 3, 3, 3, 3, 4]), 5),
    # all clients on one edge
    (np.zeros(9, int), 1),
    # every client its own edge + one empty trailing edge
    (np.arange(9), 10),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(n, d, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((n, d)).astype(np.float32),
        rng.uniform(0.05, 1.0, n).astype(np.float32),
    )


def _f32(t):
    return t.float().cpu().numpy()


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, device) for v in tree)
    return tree.to(device)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("seg,e", RAGGED_CASES + [(np.repeat(np.arange(5), [3, 4, 5, 3, 3]), 5)])
def test_segment_kernel_matches_plain_on_card(cuda, seg, e, dtype):
    tdt, tol = DTYPES[dtype], AGG_TOL[dtype]
    x, w = _inputs(len(seg), 25141)
    u = torch.tensor(x, device=cuda).to(tdt)
    s, wt = torch.tensor(seg, device=cuda), torch.tensor(w, device=cuda)
    reset_launch_counts()
    out = hier_segment_aggregate(u, s, wt, e)
    assert launch_counts()["hier_segment_aggregate"] == 1
    want = hier_segment_aggregate_ref(u, s, wt, e)
    np.testing.assert_allclose(_f32(out), _f32(want), atol=tol, rtol=tol)
    counts = np.bincount(seg, minlength=e)
    for k in np.nonzero(counts == 0)[0]:
        assert bool((out[k] == 0).all())
    for k in np.nonzero(counts == 1)[0]:
        assert torch.equal(out[k], u[int(np.nonzero(seg == k)[0][0])])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize(
    "ids,e,d",
    [(np.array([0, 7, 0, -1, 3, 5, 3, 9, 3]), 5, 25141),  # ids below 0 and at or past E
     (np.arange(21) % 19 - 1, 18, 1000),                  # many segments, int64 ids
     (np.array([2, 2, 0, 1, 2, 40, 2, 2]), 3, 1 << 17),  # large D; 5 members, two batches of loads
     (np.arange(70) * 7 % 13 - 1, 11, 4097)],             # N > 32: ids in three ballots of 32
)
def test_segment_kernel_out_of_range_ids_on_card(cuda, ids, e, d, dtype):
    """On the card an id outside [0, E) belongs to no segment (the TPU
    kernel's one-hot matches none): the kernel agrees with the numpy replay
    of its loop, and the wrapper checks nothing on the card."""
    tdt, tol = DTYPES[dtype], AGG_TOL[dtype]
    x, w = _inputs(len(ids), d, seed=7)
    u = torch.tensor(x, device=cuda).to(tdt)
    s = torch.tensor(ids, device=cuda, dtype=torch.int64 if e > 5 else torch.int32)
    reset_launch_counts()
    out = hier_segment_aggregate(u, s, torch.tensor(w, device=cuda), e)
    assert launch_counts()["hier_segment_aggregate"] == 1
    want = segment_kernel_replay(u.float().cpu().numpy(), ids, w, e)
    np.testing.assert_allclose(_f32(out), want, atol=tol, rtol=tol)


def test_segment_wrapper_never_synchronises_on_card(cuda):
    """The wrapper queues one launch and nothing that waits for the card,
    under sync-debug mode "error" (a synchronising call raises), for int32
    and int64 ids and for weights that need a cast."""
    x, w = _inputs(18, 25141)
    u, wt = torch.tensor(x, device=cuda), torch.tensor(w, device=cuda)
    ids = torch.tensor(np.repeat(np.arange(5), [3, 4, 5, 3, 3]), device=cuda)
    hier_segment_aggregate(u, ids, wt, 5)  # builds and loads the library first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for s, weights in ((ids, wt), (ids.int(), wt), (ids, wt.double())):
            hier_segment_aggregate(u, s, weights, 5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,d", [(5, 25141), (13, 14789), (32, 512)])
def test_aggregate_kernel_matches_plain_on_card(cuda, n, d, dtype):
    tdt, tol = DTYPES[dtype], AGG_TOL[dtype]
    x, w = _inputs(n, d)
    u, wt = torch.tensor(x, device=cuda).to(tdt), torch.tensor(w, device=cuda)
    reset_launch_counts()
    out = hier_aggregate(u, wt)
    assert launch_counts()["hier_aggregate"] == 1
    np.testing.assert_allclose(_f32(out), _f32(hier_aggregate_ref(u, wt)), atol=tol, rtol=tol)


VARIANT = {"float32": "simt", "bfloat16": "wgmma"}


def _flash_inputs(cuda, b, s, hq, hkv, d, dtype, seed=3):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal((b, s, h, d)), dtype=torch.float32, device=cuda).to(dtype)
            for h in (hq, hkv, hkv)]


def _flash_launch_checked(q, k, v, variant, **kw):
    """One wrapper call that must launch exactly one kernel, of ``variant``."""
    reset_launch_counts()
    out = flash_attention(q, k, v, **kw)
    assert launch_counts()["flash_attention"] == 1
    assert flash_attention.launches_by_variant == {"wgmma": 0, "simt": 0, variant: 1}
    return out


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize(
    "b,s,hq,hkv,d,window",
    [(1, 128, 4, 4, 64, None), (2, 200, 8, 2, 64, None), (1, 256, 6, 6, 32, 16),
     (2, 130, 4, 1, 128, 100), (1, 1000, 8, 2, 128, 7), (2, 77, 4, 2, 16, None),
     (1, 150, 4, 4, 96, None)],
)
def test_flash_kernel_matches_plain_on_card(cuda, b, s, hq, hkv, d, window, dtype):
    tdt, tol = DTYPES[dtype], FLASH_TOL[dtype]
    q, k, v = _flash_inputs(cuda, b, s, hq, hkv, d, tdt)
    if dtype == "bfloat16" and d < 64:  # no bf16 config has d 16 or 32: the wgmma kernel refuses them
        with pytest.raises(ValueError, match="head dims"):
            flash_attention(q, k, v, window=window)
        return
    out = _flash_launch_checked(q, k, v, VARIANT[dtype], window=window)
    np.testing.assert_allclose(_f32(out), _f32(flash_attention_ref(q, k, v, window=window)), atol=tol, rtol=tol)


@pytest.mark.parametrize("window", [None, 50])
@pytest.mark.parametrize("d", [16, 32, 64, 96, 128])
def test_flash_simt_kernel_every_head_dim_on_card(cuda, d, window):
    """The fp32 kernel at every head dim it is built for, with and without
    a window, a ragged tail past its 128-row query tile, GQA; bitwise
    repeatable; its tile equals ``SIMT_TILE``."""
    from repro_torch.kernels.flash_attention import KERNEL_HEAD_DIMS, SIMT_TILE, simt_kernel_tile

    assert d in KERNEL_HEAD_DIMS and simt_kernel_tile() == SIMT_TILE
    q, k, v = _flash_inputs(cuda, 2, 333, 8, 2, d, torch.float32, seed=d)
    out = _flash_launch_checked(q, k, v, "simt", window=window)
    np.testing.assert_allclose(_f32(out), _f32(flash_attention_ref(q, k, v, window=window)), atol=2e-5, rtol=2e-5)
    assert torch.equal(out, flash_attention(q, k, v, window=window))


def test_flash_simt_kernel_off_grid_view_on_card(cuda):
    """fp32 views whose base or strides are off the 16-byte grid take the
    kernel's 4-byte copies, and agree all the same."""
    base = torch.randn((2, 150, 3 * 64 * 4 + 1), device=cuda)
    qkv = base[:, :, 1:].unflatten(2, (12, 64))  # base 4 bytes past the grid, seq stride odd
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    out = _flash_launch_checked(q, k, v, "simt", window=40)
    np.testing.assert_allclose(_f32(out), _f32(flash_attention_ref(q, k, v, window=40)), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize(
    "b,s,hq,hkv,d,window",
    [(1, 300, 4, 2, 96, None), (2, 300, 8, 1, 96, 50), (1, 1000, 8, 2, 128, 7), (2, 1000, 5, 1, 64, None),
     (3, 77, 4, 2, 128, None), (1, 77, 8, 8, 64, 100), (4, 512, 40, 8, 128, None), (1, 2100, 4, 2, 128, 300)],
)
def test_flash_wgmma_kernel_matches_plain_on_card(cuda, b, s, hq, hkv, d, window):
    """The bf16 wgmma kernel: d 96 (64-byte swizzle), a window below the
    tile, ragged lengths, several stage laps of the ring."""
    q, k, v = _flash_inputs(cuda, b, s, hq, hkv, d, torch.bfloat16, seed=5)
    out = _flash_launch_checked(q, k, v, "wgmma", window=window)
    want = flash_attention_ref(q, k, v, window=window)
    np.testing.assert_allclose(_f32(out), _f32(want), atol=2e-2, rtol=2e-2)
    assert torch.equal(out, flash_attention(q, k, v, window=window))  # no atomics: bitwise repeatable


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_kernel_takes_strided_heads_on_card(cuda, dtype):
    """q, k, v as views of one fused projection, the way a model may hand
    them over: the kernels read them through their strides (TMA maps built
    from them for bf16)."""
    qkv = torch.randn((2, 96, 8 + 2 + 2, 64), device=cuda).to(DTYPES[dtype])
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    out = _flash_launch_checked(q, k, v, VARIANT[dtype])
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(_f32(out), _f32(flash_attention_ref(q, k, v)), atol=tol, rtol=tol)


def test_flash_wgmma_refuses_off_grid_strides_on_card(cuda):
    """A view whose sequence stride is not a multiple of 16 bytes cannot be
    read by TMA: the wrapper raises, and nothing falls back."""
    base = torch.randn((2, 64, 2 * 64 + 4), device=cuda).to(torch.bfloat16)
    q = base[:, :, :128].unflatten(2, (2, 64))  # seq stride 132 elements = 264 bytes
    reset_launch_counts()
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention(q, q[:, :, :1], q[:, :, 1:])
    assert launch_counts()["flash_attention"] == 0


def test_flash_kernel_refuses_head_dim_on_card(cuda):
    q = torch.randn((1, 16, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, q[:, :, :1], q[:, :, :1])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("t,e,k", [(8192, 40, 8), (300, 1000, 8), (33, 33, 3), (7, 1, 1), (64, 64, 70)])
def test_topk_kernel_matches_plain_on_card(cuda, t, e, k, dtype):
    x = torch.tensor(np.random.default_rng(4).standard_normal((t, e)) * 2, dtype=torch.float32, device=cuda)
    x = x.to(DTYPES[dtype])
    reset_launch_counts()
    out = topk_gating(x, k)
    assert launch_counts()["topk_gating"] == 1
    np.testing.assert_allclose(out.cpu().numpy(), topk_gating_ref(x, k).cpu().numpy(), atol=1e-5, rtol=1e-5)


def test_topk_kernel_ties_and_underflow_on_card(cuda):
    x = torch.zeros((3, 40), device=cuda)
    x[1, ::3] = 1.0
    x[2, 5] = 300.0
    np.testing.assert_array_equal(topk_gating(x, 8).cpu().numpy(), topk_gating_ref(x, 8).cpu().numpy())


def test_serving_launches_flash_once_per_layer_on_card(cuda):
    """A uniform prefill with use_flash launches the kernel once per layer;
    decode and the ragged (pad-mask) prefill launch none; and the tokens
    match the CPU run of the same parameters."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.serving import Request, ServeEngine

    cfg = dataclasses.replace(get_smoke_config("qwen3-14b"), use_flash=True)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    on_card = _to(params, cuda)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 40)).astype(np.int32)
    card = ServeEngine(cfg, params=on_card, max_seq=64, device=cuda)
    reset_launch_counts()
    out = [r.out for r in card.run([Request(p, max_new_tokens=6) for p in prompts])]
    assert launch_counts()["flash_attention"] == cfg.n_layers
    assert flash_attention.launches_by_variant == {"wgmma": 0, "simt": cfg.n_layers}  # the smoke config is fp32
    cpu = ServeEngine(cfg, params=params, max_seq=64, device="cpu")
    for a, b in zip(out, (r.out for r in cpu.run([Request(p, max_new_tokens=6) for p in prompts]))):
        np.testing.assert_array_equal(a, b)
    reset_launch_counts()
    card.run([Request(prompts[0][:10], max_new_tokens=3), Request(prompts[1], max_new_tokens=3)])
    assert launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("window", [None, 40])
def test_flash_kernel_non_causal_on_card(cuda, window):
    q, k, v = (torch.randn((2, 100, h, 64), device=cuda) for h in (4, 2, 2))
    out = flash_attention(q, k, v, causal=False, window=window)
    want = flash_attention_ref(q, k, v, causal=False, window=window)
    np.testing.assert_allclose(_f32(out), _f32(want), atol=2e-5, rtol=2e-5)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    out = _flash_launch_checked(qb, kb, vb, "wgmma", causal=False, window=window)
    want = flash_attention_ref(qb, kb, vb, causal=False, window=window)
    np.testing.assert_allclose(_f32(out), _f32(want), atol=2e-2, rtol=2e-2)
