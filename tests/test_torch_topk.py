"""The port's top-k gating: its plain version (what the wrapper runs on the
CPU) against the reference's Pallas kernel in interpret mode and its
``topk_gating_ref``; constructed ties and underflow.  The kernel against
its plain version on the card is in ``test_torch_card.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.kernels.ref import topk_gating_ref as ref_oracle  # noqa: E402
from repro.kernels.topk_gating import topk_gating as ref_gate  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts, topk_gating, topk_gating_ref  # noqa: E402
from torch_kernel_replay import topk_kernel_replay  # noqa: E402

FNS = pytest.mark.parametrize("fn", [topk_gating_ref, topk_gating], ids=["plain", "wrapper"])


def _logits(t, e, seed=0):
    return (np.random.default_rng(seed).standard_normal((t, e)) * 2).astype(np.float32)


@FNS
@pytest.mark.parametrize("t,e,k,bt", [(64, 8, 2, 32), (200, 16, 4, 64), (100, 40, 8, 128)])
def test_topk_matches_reference_kernel(fn, t, e, k, bt):
    x = _logits(t, e)
    kernel = ref_gate(jnp.asarray(x), k, block_t=bt, interpret=True)
    oracle, _ = ref_oracle(jnp.asarray(x), k)
    out = fn(torch.tensor(x), k)
    assert out.dtype == torch.float32 and tuple(out.shape) == (t, e)
    np.testing.assert_allclose(out.numpy(), np.asarray(kernel), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(oracle), atol=1e-5, rtol=1e-5)


@FNS
def test_topk_properties(fn):
    out = fn(torch.tensor(_logits(128, 16, seed=2)), 4).numpy()
    assert (np.count_nonzero(out, axis=1) == 4).all()
    np.testing.assert_allclose(out.sum(axis=1), 1.0, rtol=1e-5)


@FNS
def test_topk_ties_pick_first_max(fn):
    """Equal logits give equal probabilities; each sweep keeps the lowest
    index among them, as the TPU kernel's cumsum does."""
    x = np.zeros((3, 8), np.float32)
    x[0] = [1, 3, 3, 0, 3, 0, 0, 0]          # three-way tie for the top
    x[1] = 0.0                               # all equal
    x[2] = [5, 1, 5, 1, 5, 1, 5, 1]
    kernel = np.asarray(ref_gate(jnp.asarray(x), 2, interpret=True))
    out = fn(torch.tensor(x), 2).numpy()
    np.testing.assert_allclose(out, kernel, atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(np.nonzero(out[0])[0], [1, 2])
    np.testing.assert_array_equal(np.nonzero(out[1])[0], [0, 1])
    np.testing.assert_array_equal(np.nonzero(out[2])[0], [0, 2])
    np.testing.assert_allclose(out[:, :3].sum(axis=1), 1.0, rtol=1e-6)


@FNS
def test_topk_underflow_picks_fewer(fn):
    """Probabilities that underflow to 0 are never chosen, so a peaked row
    gets fewer than k experts."""
    x = np.full((2, 16), -200.0, np.float32)
    x[0, 5] = 0.0                          # one expert holds all the mass
    x[1, [2, 9]] = 0.0                     # two share it
    kernel = np.asarray(ref_gate(jnp.asarray(x), 4, interpret=True))
    out = fn(torch.tensor(x), 4).numpy()
    np.testing.assert_allclose(out, kernel, atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(np.nonzero(out[0])[0], [5])
    np.testing.assert_array_equal(np.nonzero(out[1])[0], [2, 9])
    np.testing.assert_allclose(out[1, [2, 9]], 0.5, rtol=1e-6)


@FNS
def test_topk_bf16_logits(fn):
    x = _logits(50, 40, seed=3)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    kernel = ref_gate(jx, 8, interpret=True)
    out = fn(torch.tensor(x).to(torch.bfloat16), 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(kernel), atol=1e-5, rtol=1e-5)


def _tie_rows(e):
    """Rows whose outputs are exact in any summation order (every logit 0
    or -200, which underflows): ties across lanes and register slots of the
    CUDA kernel (expert l + 32 i sits on lane l, slot i), and peaked rows."""
    x = np.full((5, e), -200.0, np.float32)
    x[0, [e - 1, e // 2, 1]] = 0.0  # a three-way tie over two or three slots
    x[1, [32, 31]] = 0.0         # lowest index 31 sits on the highest lane
    x[2, e - 1] = 0.0            # one expert in the last slot holds all the mass
    x[3] = 0.0                   # all equal
    x[4, [e - 1, 2]] = 0.0       # lowest index on a lower slot, higher lane
    return x


@pytest.mark.parametrize("t,e,k", [(64, 32, 8), (64, 33, 8), (64, 64, 8), (64, 65, 8), (16, 1000, 8),
                                   (100, 40, 8), (50, 40, 0), (30, 33, 40)])
def test_topk_kernel_replay_matches_reference_kernel(t, e, k):
    """The CUDA kernel's arithmetic, replayed in numpy (softmax in the
    warp's order; sweeps on the probabilities' bits, lowest index at the
    top, stop at a top of 0), against the Pallas kernel in interpret mode,
    at E on each side of the kernel's register-slot counts, k = 0 and
    k > E: the same experts, and values within 1e-5."""
    x = _logits(t, e, seed=e)
    got = topk_kernel_replay(x, k)
    want = np.asarray(ref_gate(jnp.asarray(x), k, interpret=True))
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("k", [0, 1, 2, 8, 40])
@pytest.mark.parametrize("e", [33, 65, 1000])
def test_topk_kernel_replay_ties_and_underflow_exact(e, k):
    """Ties and underflow: the replay's choices and values equal the Pallas
    kernel's bit for bit, though the replay stops at the first sweep whose
    top is 0 and the Pallas kernel runs all k."""
    x = _tie_rows(e)
    got = topk_kernel_replay(x, k)
    np.testing.assert_array_equal(got, np.asarray(ref_gate(jnp.asarray(x), k, interpret=True)))
    if k == 1:
        np.testing.assert_array_equal([np.flatnonzero(r)[0] for r in got], [1, 31, e - 1, 0, 2])


def test_topk_rejects_bad_input():
    with pytest.raises(ValueError, match="k must"):
        topk_gating(torch.zeros(4, 8), -1)
    with pytest.raises(ValueError, match=r"\(T, E\)"):
        topk_gating(torch.zeros(4), 1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        topk_gating(torch.zeros(4, 8, dtype=torch.float64), 1)


def test_cpu_wrapper_launches_nothing():
    reset_launch_counts()
    topk_gating(torch.tensor(_logits(8, 8)), 2)
    assert launch_counts()["topk_gating"] == 0


def test_reference_oracle_agrees_with_lax_top_k():
    """Guard of the test's own premise: the reference's two versions agree."""
    x = jnp.asarray(_logits(32, 12, seed=5))
    np.testing.assert_allclose(
        np.asarray(ref_gate(x, 3, interpret=True)), np.asarray(ref_oracle(x, 3)[0]), atol=1e-6
    )
    assert jax.devices()[0].platform == "cpu"
