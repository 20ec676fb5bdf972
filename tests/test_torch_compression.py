"""Uplink compression: the port's top-k and ternary compressions, their
payload accounting and the flat engines' error feedback against the JAX
package on the same inputs, then the readable simulator and both sync
pipelines under top-k against the reference's runs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core.compression import CompressionSpec as RefCompressionSpec  # noqa: E402
from repro.core.compression import ternarize as ref_ternarize  # noqa: E402
from repro.core.compression import topk_sparsify as ref_topk_sparsify  # noqa: E402
from repro.engine.flatten import compress_flat_upload as ref_compress_flat_upload  # noqa: E402
from repro_torch.core.compression import CompressionSpec, ternarize, topk_sparsify  # noqa: E402
from repro_torch.engine.flatten import compress_flat_rows, compress_flat_upload  # noqa: E402
from repro_torch.federated import build_scenario  # noqa: E402
from torch_parity import ReferencePopulation, check_run, reference_inits  # noqa: E402


def _tree(seed: int, ties: bool = False) -> dict:
    """A CNN-like tree of leaves from ``seed``; with ``ties`` most magnitudes
    repeat (a few distinct values, both signs), so the top-k cutoff falls
    inside a run of equal magnitudes."""
    rng = np.random.default_rng(seed)
    shapes = {"conv": {"w": (5, 4, 8), "b": (8,)}, "dense": {"w": (37, 5), "b": (5,)}}

    def leaf(shape):
        if ties:
            return rng.choice([-0.5, 0.5, -0.25, 0.25, 1.0], size=shape).astype(np.float32)
        return rng.standard_normal(shape).astype(np.float32)

    return {k: {n: leaf(s) for n, s in v.items()} for k, v in shapes.items()}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.tensor(v) for k, v in tree.items()}


def _to_jax(tree):
    return {k: _to_jax(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def _leaves_np(tree):
    return [np.asarray(leaf) for leaf in jax.tree.leaves(jax.tree.map(np.asarray, tree))]


def _port_leaves(tree):
    from repro_torch.utils.tree import tree_leaves

    return [leaf.numpy() for leaf in tree_leaves(tree)]


@pytest.mark.parametrize("fraction", [0.01, 0.05, 0.3])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_topk_masks_match_lax_top_k(fraction, ties):
    """Per leaf, the same entries kept as ``jax.lax.top_k`` keeps (ties at
    the cutoff to the lower position), exactly ``max(1, ceil(n * f))`` of
    them, and the same error state, with an error carried in."""
    tree = _tree(1, ties)
    error = _tree(2, ties) if not ties else None
    want, want_err = ref_topk_sparsify(_to_jax(tree), fraction, None if error is None else _to_jax(error))
    got, got_err = topk_sparsify(_to_torch(tree), fraction, None if error is None else _to_torch(error))
    for w, g, we, ge in zip(_leaves_np(want), _port_leaves(got), _leaves_np(want_err), _port_leaves(got_err)):
        np.testing.assert_array_equal(g != 0, w != 0)
        assert int(np.count_nonzero(g)) == max(1, int(np.ceil(g.size * fraction)))
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(ge, we)


def test_topk_tie_run_keeps_lowest_positions():
    """All-equal magnitudes: the first k positions are kept, as
    ``lax.top_k`` keeps them, with every sign."""
    x = np.where(np.arange(100) % 3 == 0, -1.0, 1.0).astype(np.float32)
    (got, _), (want, _) = topk_sparsify(torch.tensor(x), 0.1), ref_topk_sparsify(jnp.asarray(x), 0.1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(np.nonzero(got.numpy())[0], np.arange(10))


def test_ternarize_matches_reference():
    tree, error = _tree(3), _tree(4)
    want, want_err = ref_ternarize(_to_jax(tree), _to_jax(error))
    got, got_err = ternarize(_to_torch(tree), _to_torch(error))
    for w, g in zip(_leaves_np(want) + _leaves_np(want_err), _port_leaves(got) + _port_leaves(got_err)):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)


@pytest.mark.parametrize(
    "spec", [dict(kind="none"), dict(kind="topk", fraction=0.05), dict(kind="topk", fraction=0.013, index_bits=16),
             dict(kind="ternary")],
    ids=lambda s: "-".join(map(str, s.values())),
)
def test_bits_equal_reference(spec):
    """The payload on the tree (the readable simulator's) and on the flat
    row (the engines'), equal with ``==``."""
    tree = _tree(0)
    flat = np.zeros(sum(v.size for v in jax.tree.leaves(tree)), np.float32)
    port, ref = CompressionSpec(**spec), RefCompressionSpec(**spec)
    assert port.bits(_to_torch(tree)) == ref.bits(_to_jax(tree))
    assert port.bits(torch.tensor(flat)) == ref.bits(jnp.asarray(flat))


@pytest.mark.parametrize("kind", ["topk", "ternary"])
def test_flat_error_feedback_over_three_rounds(kind):
    """Two clients, three rounds of ``compress_flat_upload``: the uploads
    and each client's error state against the reference's.  Top-k is exact;
    ternary to 1e-6."""
    rng = np.random.default_rng(5)
    d = 4001
    spec_kw = dict(kind=kind, fraction=0.05)
    port, ref = CompressionSpec(**spec_kw), RefCompressionSpec(**spec_kw)
    errors, ref_errors = {}, {}
    tol = 0.0 if kind == "topk" else 1e-6
    for _ in range(3):
        for cid in (0, 1):
            start = rng.standard_normal(d).astype(np.float32)
            trained = start + 0.01 * rng.standard_normal(d).astype(np.float32)
            got = compress_flat_upload(port, errors, cid, torch.tensor(start), torch.tensor(trained))
            want = ref_compress_flat_upload(ref, ref_errors, cid, jnp.asarray(start), jnp.asarray(trained))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=0)
    for cid in (0, 1):
        np.testing.assert_allclose(errors[cid].numpy(), np.asarray(ref_errors[cid]), atol=tol, rtol=0)


@pytest.mark.parametrize("kind", ["topk", "ternary"])
def test_batched_rows_equal_row_calls(kind):
    """The device pipeline's batched call gives each row, and each error
    state, exactly what the one-row call gives."""
    rng = np.random.default_rng(6)
    spec = CompressionSpec(kind=kind, fraction=0.05)
    starts = torch.tensor(rng.standard_normal((4, 3001)).astype(np.float32))
    trained = starts + torch.tensor(np.round(rng.standard_normal((4, 3001)) * 4) / 64).float()  # many ties
    errors = {1: torch.tensor(rng.standard_normal(3001).astype(np.float32))}
    solo = {1: errors[1].clone()}
    got = compress_flat_rows(spec, errors, [0, 1, 2, 3], starts, trained)
    for c in range(4):
        want = compress_flat_upload(spec, solo, c, starts[c], trained[c])
        assert torch.equal(got[c], want)
        assert torch.equal(errors[c], solo[c])


# -- the engines under top-k against the JAX package ---------------------------
CAPPED = [{"max_steps": 4}] * 18


@pytest.fixture(scope="module")
def pair():
    """The heartbeat population at ``scale=0.02`` with local epochs capped
    at 4 steps (two step buckets, so the reference compiles two cohort
    shapes, not six), and the same population in the reference package."""
    sc = build_scenario("heartbeat", scale=0.02, seed=0, n_test_per_class=20, device="cpu", hparams=CAPPED)
    with reference_inits():
        yield ReferencePopulation(sc), sc


@pytest.mark.parametrize(
    "engine,pipeline,kind", [("reference", "device", "topk"), ("sync", "host", "topk"), ("sync", "device", "topk"),
                             ("sync", "device", "ternary")],
    ids=["reference-topk", "sync-host-topk", "sync-device-topk", "sync-device-ternary"],
)
def test_engines_under_compression_match_reference(pair, engine, pipeline, kind):
    """Two cloud rounds of two edge rounds with error feedback carried
    across them (at upp 0.8 on the simulator, so a client that sits a round
    out keeps its error state; full participation on the sync pipelines,
    whose reference compiles a cohort per participant count): accuracy
    1e-6, parameters 5e-3, the nine accountant totals and per-EU traffic
    exact."""
    from repro.core.hfl import HFLSchedule as RefSchedule
    from repro_torch.core import HFLSchedule

    ref, sc = pair
    lam = sc.assign("eara-sca", device="cpu").lam
    spec = CompressionSpec(kind=kind, fraction=0.05)
    kw = dict(seed=2, upp=0.8 if engine == "reference" else 1.0)
    want = ref.simulate(lam, 2, engine=engine, pipeline=pipeline, compression=spec, schedule=RefSchedule(1, 2), **kw)
    got = sc.simulate(lam, 2, engine=engine, pipeline=pipeline, compression=spec, schedule=HFLSchedule(1, 2),
                      device="cpu", **kw)
    check_run(want, got)
