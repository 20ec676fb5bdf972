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
from torch_segment_replay import segment_kernel_replay  # noqa: E402

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
    RAGGED_CASES
    + [
        (np.array([3, 0, 4, 0, 3, 1, 0, 3, 4]), 6),
        (np.array([2, 2, 0, 1, 2]), 3),
        (np.array([0, 7, 0, -1, 3, 5, 3, 9, 3]), 5),  # ids outside [0, E) belong to no segment
        (np.arange(21) % 19, 19),  # many segments, one block each, one member or two
        (np.arange(40) % 7, 7),  # N > 32: the ids in two ballots of 32
    ],
)
def test_segment_kernel_loop_matches_reference_kernel(seg, e):
    """The CUDA segment kernel's loop, replayed in numpy (member rows listed
    in row order, in-kernel denominators in row order, out-of-range ids
    dropped), against the reference's Pallas kernel in interpret mode,
    whose one-hot matches no out-of-range id either."""
    x, w = _inputs(len(seg), 33, seed=4)
    got = segment_kernel_replay(x, seg, w, e)
    want = ref_seg(jnp.asarray(x), jnp.asarray(seg), jnp.asarray(w), e, block=16, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)
    counts = np.bincount(seg[(seg >= 0) & (seg < e)], minlength=e)
    for s in np.nonzero(counts == 0)[0]:
        assert np.all(got[s] == 0)
    for s in np.nonzero(counts == 1)[0]:
        np.testing.assert_array_equal(got[s], x[np.nonzero(seg == s)[0][0]])


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


@pytest.mark.parametrize("code,match", [(0, None), (700, "cudaError 700"), (-2, "refused its inputs")])
def test_check_launch_codes(code, match):
    """0 passes; a CUDA error and a refusal before the launch both raise."""
    from repro_torch.kernels.common import check_launch

    if match is None:
        check_launch(code, "k")
    else:
        with pytest.raises(RuntimeError, match=match):
            check_launch(code, "k")


def test_reset_zeroes_flash_variant_counts():
    flash_attention.launches_by_variant["wgmma"] = 3
    flash_attention.launches_by_variant["simt"] = 1
    reset_launch_counts()
    assert flash_attention.launches_by_variant == {"wgmma": 0, "simt": 0}
