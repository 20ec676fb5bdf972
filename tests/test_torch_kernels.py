"""The port's FedAvg kernels: plain versions and public wrappers against the
reference's Pallas kernels (interpret mode), on the reference's own cases.

On the CPU the wrappers take the plain versions; the kernel-vs-plain cases
need a CUDA card and are in ``test_torch_card.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.kernels.hier_aggregate import hier_aggregate as ref_agg  # noqa: E402
from repro.kernels.segment_aggregate import hier_segment_aggregate as ref_seg  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    flash_attention,
    hier_aggregate,
    hier_aggregate_ref,
    hier_segment_aggregate,
    hier_segment_aggregate_ref,
    launch_counts,
    reset_launch_counts,
    topk_gating,
)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5), "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
RAGGED_CASES = [
    # empty segment (2), single-client segment (4)
    (np.array([0, 0, 0, 1, 3, 3, 3, 3, 4]), 5),
    # all clients on one edge
    (np.zeros(9, int), 1),
    # every client its own edge + one empty trailing edge
    (np.arange(9), 10),
]


def _inputs(n, d, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((n, d)).astype(np.float32),
        rng.uniform(0.05, 1.0, n).astype(np.float32),
    )


def _as_f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32), np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,d,block", [(4, 1000, 256), (13, 14789, 4096), (32, 512, 512)])
@pytest.mark.parametrize("fn", [hier_aggregate_ref, hier_aggregate], ids=["plain", "wrapper"])
def test_hier_aggregate_matches_reference_kernel(fn, dtype, n, d, block):
    jdt, tdt, tol = DTYPES[dtype]
    x, w = _inputs(n, d)
    ref = ref_agg(jnp.asarray(x).astype(jdt), jnp.asarray(w), block=block, interpret=True)
    out = fn(torch.tensor(x).to(tdt), torch.tensor(w))
    assert out.dtype == tdt and tuple(out.shape) == (d,)
    np.testing.assert_allclose(_as_f32(out), _as_f32(ref), atol=tol, rtol=tol)


@pytest.mark.parametrize("fn", [hier_aggregate_ref, hier_aggregate], ids=["plain", "wrapper"])
def test_hier_aggregate_is_fedavg(fn):
    u = torch.stack([torch.full((100,), 1.0), torch.full((100,), 3.0)])
    np.testing.assert_allclose(fn(u, torch.tensor([1.0, 3.0])).numpy(), 2.5, rtol=1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("seg,e", RAGGED_CASES)
@pytest.mark.parametrize("d,block", [(257, 64), (1000, 4096)])
@pytest.mark.parametrize("fn", [hier_segment_aggregate_ref, hier_segment_aggregate], ids=["plain", "wrapper"])
def test_segment_aggregate_matches_reference_kernel(fn, seg, e, d, block, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x, w = _inputs(len(seg), d)
    ref = ref_seg(jnp.asarray(x).astype(jdt), jnp.asarray(seg), jnp.asarray(w), e, block=block, interpret=True)
    out = fn(torch.tensor(x).to(tdt), torch.tensor(seg), torch.tensor(w), e)
    assert out.dtype == tdt and tuple(out.shape) == (e, d)
    np.testing.assert_allclose(_as_f32(out), _as_f32(ref), atol=tol, rtol=tol)


@pytest.mark.parametrize("fn", [hier_segment_aggregate_ref, hier_segment_aggregate], ids=["plain", "wrapper"])
def test_segment_aggregate_edge_semantics(fn):
    """Empty segments are exact zero rows, single-client segments return
    the row exactly, and one full segment equals ``hier_aggregate``."""
    x, w = _inputs(9, 300, seed=2)
    u, wt = torch.tensor(x), torch.tensor(w)
    out = fn(u, torch.tensor([0, 0, 0, 1, 3, 3, 3, 3, 4]), wt, 5)
    assert torch.equal(out[2], torch.zeros(300))
    assert torch.equal(out[4], u[8])
    assert torch.equal(out[1], u[3])
    one = fn(u, torch.zeros(9, dtype=torch.int64), wt, 1)
    np.testing.assert_allclose(one[0].numpy(), hier_aggregate(u, wt).numpy(), atol=1e-6)
    # a non-member row holding inf / NaN stays out of other segments
    bad = u.clone()
    bad[8] = float("inf")
    bad[3] = float("nan")
    out = fn(bad, torch.tensor([0, 0, 0, 1, 3, 3, 3, 3, 4]), wt, 5)
    assert bool(torch.isfinite(out[[0, 2, 3]]).all())


@pytest.mark.parametrize("fn", [hier_segment_aggregate_ref, hier_segment_aggregate], ids=["plain", "wrapper"])
def test_segment_aggregate_is_per_edge_fedavg(fn):
    u = torch.stack([torch.full((64,), v) for v in (1.0, 3.0, 10.0)])
    out = fn(u, torch.tensor([0, 0, 1]), torch.tensor([1.0, 3.0, 7.0]), 2)
    np.testing.assert_allclose(out[0].numpy(), 2.5, rtol=1e-6)
    np.testing.assert_allclose(out[1].numpy(), 10.0, rtol=1e-6)


@pytest.mark.parametrize(
    "call,err",
    [
        (lambda u, s, w: hier_segment_aggregate(u.double(), s, w, 5), TypeError),
        (lambda u, s, w: hier_segment_aggregate(u.t(), s, w, 5), ValueError),
        (lambda u, s, w: hier_segment_aggregate(u, s, w, 4), ValueError),
        (lambda u, s, w: hier_segment_aggregate(u, -s, w, 5), ValueError),
        (lambda u, s, w: hier_segment_aggregate(u, s[:-1], w, 5), ValueError),
        (lambda u, s, w: hier_segment_aggregate(u, s.float(), w, 5), TypeError),
        (lambda u, s, w: hier_segment_aggregate(u[0], s, w, 5), ValueError),
        (lambda u, s, w: hier_aggregate(u.double(), w), TypeError),
        (lambda u, s, w: hier_aggregate(u, w[:-1]), ValueError),
        (lambda u, s, w: hier_aggregate(u, s), TypeError),
        (lambda u, s, w: hier_aggregate(u.numpy(), w), TypeError),
    ],
)
def test_wrappers_reject_bad_inputs(call, err):
    x, w = _inputs(9, 9)
    seg = torch.tensor([0, 0, 0, 1, 3, 3, 3, 3, 4])
    with pytest.raises(err):
        call(torch.tensor(x), seg, torch.tensor(w))


@pytest.mark.parametrize(
    "seg,e",
    RAGGED_CASES + [(np.array([3, 0, 4, 0, 3, 1, 0, 3, 4]), 6), (np.array([2, 2, 0, 1, 2]), 3)],
)
def test_segment_runs_feed_the_kernel_loop(seg, e):
    """The grouping the CUDA kernel walks (rows sorted stably by segment,
    per-segment offsets), replayed in numpy as the kernel's loop runs it:
    one fp32 accumulator per (segment, column), rows in their order."""
    from repro_torch.kernels.segment_aggregate import _normalized_weights, _segment_runs

    x, w = _inputs(len(seg), 33, seed=4)
    seg64 = torch.tensor(seg, dtype=torch.int64)
    rows, offs = _segment_runs(seg64, e)
    assert rows.dtype == offs.dtype == torch.int32 and tuple(offs.shape) == (e + 1,)
    rows, offs = rows.numpy(), offs.numpy()
    wn = _normalized_weights(seg64, torch.tensor(w), e).numpy()
    out = np.zeros((e, x.shape[1]), np.float32)
    for s in range(e):
        members = rows[offs[s] : offs[s + 1]]
        np.testing.assert_array_equal(members, np.nonzero(seg == s)[0])  # stable
        for i in members:
            out[s] += wn[i] * x[i]
    want = hier_segment_aggregate_ref(torch.tensor(x), seg64, torch.tensor(w), e).numpy()
    np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-6)


def test_cpu_wrappers_launch_nothing():
    reset_launch_counts()
    x, w = _inputs(9, 40)
    hier_aggregate(torch.tensor(x), torch.tensor(w))
    hier_segment_aggregate(torch.tensor(x), torch.zeros(9, dtype=torch.int32), torch.tensor(w), 1)
    qkv = torch.tensor(x[:, :32]).reshape(1, 9, 2, 16)
    flash_attention(qkv, qkv, qkv)
    topk_gating(torch.tensor(x), 2)
    assert launch_counts() == {
        "hier_segment_aggregate": 0, "hier_aggregate": 0, "flash_attention": 0, "topk_gating": 0,
    }
