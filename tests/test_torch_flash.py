"""The port's flash attention: its plain version (what the wrapper runs on
the CPU) against the reference's Pallas kernel in interpret mode and its
``flash_attention_ref``, on the reference's own sweep.  The kernel against
its plain version on the card is in ``test_torch_card.py``."""
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
