"""The port's flat-buffer layer against the reference's: JAX leaf order,
round trips, uniform dtypes, and both FedAvg backends."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.engine.flatten import flat_mean as ref_flat_mean  # noqa: E402
from repro.engine.flatten import flat_segment_mean as ref_flat_segment_mean  # noqa: E402
from repro.models.cnn1d import HEARTBEAT_CNN as REF_CNN  # noqa: E402
from repro.models.cnn1d import cnn_init as ref_cnn_init  # noqa: E402
from repro.utils.tree import tree_ravel as ref_tree_ravel  # noqa: E402
from repro.utils.tree import tree_size_bytes as ref_tree_size_bytes  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.engine.flatten import (  # noqa: E402
    BACKENDS,
    FlatPack,
    flat_mean,
    flat_segment_mean,
    ravel_batched,
    unravel_batched,
)
from repro_torch.utils.tree import tree_leaves, tree_size_bytes, tree_unravel  # noqa: E402


def _ref_params(seed=0):
    return jax.tree.map(np.asarray, ref_cnn_init(jax.random.PRNGKey(seed), REF_CNN))


def test_flatpack_uses_jax_leaf_order_and_row():
    ref = _ref_params()
    params = params_from_numpy(ref)
    pack = FlatPack(params)
    assert pack.spec.paths == (
        ("conv1", "b"), ("conv1", "w"), ("conv2", "b"), ("conv2", "w"),
        ("fc1", "b"), ("fc1", "w"), ("fc2", "b"), ("fc2", "w"),
    )
    row = pack.ravel(params).numpy()
    ref_row = np.asarray(ref_tree_ravel(ref)[0])
    assert row.dtype == ref_row.dtype and row.tobytes() == ref_row.tobytes()
    # dict insertion order does not change the layout
    shuffled = {k: dict(reversed(list(v.items()))) for k, v in reversed(list(params.items()))}
    assert pack.ravel(shuffled).numpy().tobytes() == ref_row.tobytes()
    assert tree_size_bytes(params) == ref_tree_size_bytes(ref)


def test_unravel_round_trips():
    params = params_from_numpy(_ref_params())
    pack = FlatPack(params)
    back = pack.unravel(pack.ravel(params))
    for a, b in zip(tree_leaves(params), tree_leaves(back)):
        assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
    trees = [params_from_numpy(_ref_params(s)) for s in range(3)]
    mat = pack.stack(trees)
    stacked = unravel_batched(pack.spec, mat)
    assert torch.equal(ravel_batched(stacked), mat)
    for c in range(3):
        one = params_to_numpy({k: {kk: v[c] for kk, v in d.items()} for k, d in stacked.items()})
        for a, b in zip(tree_leaves(params_from_numpy(one)), tree_leaves(trees[c])):
            assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tree_unravel(pack.spec, torch.zeros(5))


@pytest.mark.parametrize(
    "tree",
    [
        {"a": torch.zeros(3), "b": torch.zeros(2, dtype=torch.float64)},
        {"a": {"w": torch.zeros(3, dtype=torch.float64)}, "b": torch.zeros(2)},
        {"a": torch.zeros(3), "b": torch.zeros(2, dtype=torch.bfloat16)},
        {"a": torch.zeros(3), "b": torch.zeros(2, dtype=torch.int32)},
    ],
)
def test_flatpack_rejects_mixed_dtypes_including_float64(tree):
    with pytest.raises(ValueError, match="uniform leaf dtype"):
        FlatPack(tree)


def test_flatpack_rejects_other_layouts():
    pack = FlatPack({"a": torch.zeros(3), "b": torch.zeros(2)})
    with pytest.raises(ValueError, match="layout"):
        pack.ravel({"a": torch.zeros(3), "c": torch.zeros(2)})
    with pytest.raises(TypeError):
        FlatPack({"a": [torch.zeros(3)]})


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", [1, 5, 13])
def test_flat_mean_matches_reference(backend, n):
    rng = np.random.default_rng(n)
    u = rng.standard_normal((n, 301)).astype(np.float32)
    w = rng.uniform(0.5, 3.0, n).astype(np.float32)
    want = np.asarray(ref_flat_mean(jnp.asarray(u), w, backend="reference"))
    got = flat_mean(torch.tensor(u), w, backend=backend).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(ref_flat_mean(jnp.asarray(u), w, backend="pallas")), atol=1e-5, rtol=1e-5
    )


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize(
    "seg,e", [(np.array([0, 0, 1, 1, 1, 3, 3, 3, 3]), 4), (np.arange(9) % 2, 2), (np.arange(9), 40)]
)
def test_flat_segment_mean_matches_reference(backend, seg, e):
    rng = np.random.default_rng(e)
    u = rng.standard_normal((len(seg), 301)).astype(np.float32)
    w = np.linspace(0.5, 2.0, len(seg)).astype(np.float32)
    want = np.asarray(ref_flat_segment_mean(jnp.asarray(u), seg, w, e, backend="reference"))
    got = flat_segment_mean(torch.tensor(u), seg, w, e, backend=backend).numpy()
    assert got.shape == (e, 301)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="backend"):
        flat_mean(torch.zeros(2, 3), [1.0, 1.0], backend="pallas")
    with pytest.raises(ValueError, match="backend"):
        flat_segment_mean(torch.zeros(2, 3), [0, 1], [1.0, 1.0], 2, backend="pallas")
