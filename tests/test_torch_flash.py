"""The port's flash attention: its plain version (what the wrapper runs on
the CPU) against the reference's Pallas kernel in interpret mode and its
``flash_attention_ref``, on the reference's own sweep.  The kernel against
its plain version on the card is in ``test_torch_card.py``."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.kernels.flash_attention import flash_attention as ref_flash  # noqa: E402
from repro.kernels.ref import flash_attention_ref as ref_oracle  # noqa: E402
from repro_torch.kernels import flash_attention, flash_attention_ref, launch_counts, reset_launch_counts  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5), "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
SWEEP = [
    (1, 128, 4, 4, 64, 64, 64),     # MHA
    (2, 256, 8, 2, 64, 128, 64),    # GQA 4:1
    (1, 256, 6, 6, 32, 64, 128),    # non-pow2 heads
    (2, 128, 4, 1, 128, 32, 32),    # MQA
]


def _qkv(b, s, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((b, s, hq, d)).astype(np.float32),
        rng.standard_normal((b, s, hkv, d)).astype(np.float32),
        rng.standard_normal((b, s, hkv, d)).astype(np.float32),
    )


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32), np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,s,hq,hkv,d,bq,bk", SWEEP)
@pytest.mark.parametrize("fn", [flash_attention_ref, flash_attention], ids=["plain", "wrapper"])
def test_flash_matches_reference_kernel(fn, b, s, hq, hkv, d, bq, bk, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _qkv(b, s, hq, hkv, d)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    kernel = ref_flash(jq, jk, jv, causal=True, block_q=bq, block_k=bk, interpret=True)
    oracle = ref_oracle(jq, jk, jv, causal=True)
    out = fn(*(torch.tensor(a).to(tdt) for a in (q, k, v)), causal=True)
    assert out.dtype == tdt and tuple(out.shape) == (b, s, hq, d)
    np.testing.assert_allclose(_f32(out), _f32(kernel), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(out), _f32(oracle), atol=tol, rtol=tol)


@pytest.mark.parametrize("window", [16, 64, 100])
def test_flash_sliding_window(window):
    q, k, v = _qkv(2, 128, 4, 4, 32, seed=1)
    kernel = ref_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=True, window=window,
                       block_q=32, block_k=32, interpret=True)
    oracle = ref_oracle(*(jnp.asarray(a) for a in (q, k, v)), causal=True, window=window)
    out = flash_attention(*(torch.tensor(a) for a in (q, k, v)), causal=True, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(kernel), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(oracle), atol=2e-5, rtol=2e-5)


def test_flash_non_causal_matches_oracle():
    q, k, v = _qkv(1, 64, 4, 2, 16, seed=2)
    oracle = ref_oracle(*(jnp.asarray(a) for a in (q, k, v)), causal=False)
    out = flash_attention_ref(*(torch.tensor(a) for a in (q, k, v)), causal=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(oracle), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("fn", [flash_attention_ref, flash_attention], ids=["plain", "wrapper"])
def test_flash_rejects_bad_shapes(fn):
    q, k, v = (torch.tensor(a) for a in _qkv(1, 32, 4, 2, 16))
    with pytest.raises(ValueError, match="sq must equal sk"):
        fn(q[:, :16], k, v)
    with pytest.raises(ValueError, match="multiple"):
        fn(q[:, :, :3], k, v)
    with pytest.raises(ValueError, match="window"):
        fn(q, k, v, window=0)
    with pytest.raises(TypeError, match="dtype"):
        fn(q, k.double(), v)


def test_cpu_wrapper_launches_nothing():
    reset_launch_counts()
    flash_attention(*(torch.tensor(a) for a in _qkv(1, 16, 2, 1, 16)))
    assert launch_counts()["flash_attention"] == 0


# -- the bf16 wgmma kernel's numerics (csrc/flash_attention_sm90.cu) ----------

_KERNEL_TILE = 128  # query rows per CTA and key rows per tile
NEG_INF = -1e30


def _wgmma_numerics(q, k, v, *, causal=True, window=None):
    """Attention computed the way the bf16 wgmma kernel computes it: per
    128-row query tile, the 128-row key tiles it visits (tiles outside the
    causal band or the window skipped, the ragged tail zero-filled and
    masked), logits in the base-2 domain with the finite -1e30 mask, fp32
    running max / sum / accumulator, and p rounded to bf16 for p . v (the
    sum adds the fp32 p).  q, k, v: (B, S, H, D) torch tensors in bf16."""
    b, s, hq, d = q.shape
    g = hq // k.shape[2]
    t = _KERNEL_TILE
    c = np.float32(1.0 / np.sqrt(d) * np.log2(np.e))
    pad = -(-s // t) * t - s
    qf = q.float().permute(0, 2, 1, 3)                                        # (B, Hq, S, D)
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))           # zero-filled tail
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    kf = kf.repeat_interleave(g, dim=2).permute(0, 2, 1, 3)                   # (B, Hq, S + pad, D)
    vf = vf.repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    out = torch.empty((b, hq, s, d), dtype=torch.float32)
    for q0 in range(0, s, t):
        rows = torch.arange(q0, min(q0 + t, s))
        k_end = min(q0 + t, s) if causal else s
        k_begin = max(0, q0 - window + 1) if window else 0
        m = torch.full((b, hq, len(rows)), NEG_INF)
        l = torch.zeros((b, hq, len(rows)))
        acc = torch.zeros((b, hq, len(rows), d))
        for k0 in range(k_begin // t * t, k_end, t):
            keys = torch.arange(k0, k0 + t)
            x = (qf[:, :, rows] @ kf[:, :, k0:k0 + t].transpose(-1, -2)) * c
            ok = (keys[None, :] < s).expand(len(rows), t)
            if causal:
                ok = ok & (keys[None, :] <= rows[:, None])
            if window:
                ok = ok & (keys[None, :] > rows[:, None] - window)
            x = torch.where(ok, x, torch.tensor(NEG_INF))
            m_new = torch.maximum(m, x.amax(-1))
            p = torch.exp2(x - m_new[..., None])
            alpha = torch.exp2(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p.to(torch.bfloat16).float() @ vf[:, :, k0:k0 + t]
            m = m_new
        out[:, :, rows] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


WGMMA_CASES = {
    # id: B, S, Hq, Hkv, D, window
    "mha": (1, 256, 4, 4, 64, None),
    "gqa-5:1": (1, 256, 10, 2, 128, None),
    "mqa": (2, 128, 4, 1, 128, None),
    "d96": (1, 256, 2, 2, 96, None),
    "s77": (2, 77, 4, 2, 64, None),
    "s130": (1, 130, 4, 2, 128, None),
    "window7": (1, 300, 2, 1, 64, 7),
    "window100": (1, 300, 2, 2, 128, 100),
    "window200": (2, 260, 2, 1, 64, 200),
}


@pytest.mark.parametrize("against", ["pallas", "oracle"])
@pytest.mark.parametrize("case", list(WGMMA_CASES))
def test_wgmma_numerics_match_reference(case, against):
    """The kernel's one numerical change (p rounded to bf16 for p . v) and
    its tile skipping stay within the reference's bf16 tolerance."""
    b, s, hq, hkv, d, window = WGMMA_CASES[case]
    q, k, v = _qkv(b, s, hq, hkv, d, seed=5)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    if against == "pallas":
        block = 128 if s % 128 == 0 else s
        want = ref_flash(jq, jk, jv, causal=True, window=window, block_q=block, block_k=block, interpret=True)
    else:
        want = ref_oracle(jq, jk, jv, causal=True, window=window)
    got = _wgmma_numerics(*(torch.tensor(a).to(torch.bfloat16) for a in (q, k, v)), window=window)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, s, hq, d)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-2, rtol=2e-2)


def test_wgmma_numerics_first_empty_tile():
    """A window below the tile leaves rows whose first visited key tile
    holds none of their keys; the -1e30 mask keeps them finite and exact
    to the plain version."""
    q, k, v = (torch.tensor(a).to(torch.bfloat16) for a in _qkv(1, 300, 2, 1, 64, seed=6))
    got = _wgmma_numerics(q, k, v, window=3)
    want = flash_attention_ref(q, k, v, window=3)
    assert bool(torch.isfinite(got.float()).all())
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-2, rtol=2e-2)


def _bf16_view(shape, strides, offset=0):
    return torch.zeros(1 << 16, dtype=torch.bfloat16).as_strided(shape, strides, offset)


@pytest.mark.parametrize(
    "what,q_args,match",
    [
        ("fused projection", ((2, 16, 4, 64), (16 * 512, 512, 64, 1)), None),
        ("head dim 32", ((2, 16, 4, 32), (16 * 128, 128, 32, 1)), "head dims"),
        ("seq stride off the 16-byte grid", ((1, 16, 2, 64), (16 * 132, 132, 64, 1)), "multiples of 16 bytes"),
        ("base off the 16-byte grid", ((1, 16, 2, 64), (16 * 128, 128, 64, 1), 4), "16-byte aligned"),
    ],
)
def test_wgmma_input_check(what, q_args, match):
    """The bf16 kernel's refusals (checked before any launch): TMA needs
    16-byte aligned addresses and strides, and the head dims it is built
    for.  The same check runs on CUDA tensors before the launch."""
    mod = importlib.import_module("repro_torch.kernels.flash_attention")
    q = _bf16_view(*q_args)
    kv = _bf16_view((q.shape[0], q.shape[1], 1, q.shape[3]), (q.shape[1] * 128, 128, 128, 1))
    if match is None:
        mod._check_wgmma(q, kv, kv, "flash_attention")
    else:
        with pytest.raises(ValueError, match=match):
            mod._check_wgmma(q, kv, kv, "flash_attention")
