"""The port's copies of the numpy data modules give byte-equal scenarios."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.federated import build_scenario as ref_build  # noqa: E402
from repro_torch.federated import build_scenario  # noqa: E402


@pytest.mark.parametrize("dataset", ["heartbeat", "seizure"])
def test_scenario_data_byte_equal(dataset):
    ref = ref_build(dataset, scale=0.02, seed=3, n_test_per_class=20)
    sc = build_scenario(dataset, scale=0.02, seed=3, n_test_per_class=20, device="cpu")
    assert sc.class_counts.dtype == ref.class_counts.dtype
    np.testing.assert_array_equal(sc.class_counts, ref.class_counts)
    np.testing.assert_array_equal(sc.init_edge, ref.init_edge)
    assert len(sc.clients) == len(ref.clients)
    for a, b in zip(sc.clients, ref.clients):
        assert a.shard.x.tobytes() == b.shard.x.tobytes()
        assert a.shard.y.tobytes() == b.shard.y.tobytes()
        assert a.shard.n_classes == b.shard.n_classes
        assert a.plan_steps() == b.plan_steps()
    assert sc.test.x.tobytes() == ref.test.x.tobytes()
    assert sc.test.y.tobytes() == ref.test.y.tobytes()
    assert sc.model_bits == ref.model_bits
    assert sc.n_edges == ref.n_edges


def test_data_functions_byte_equal():
    from repro.data import dirichlet_partition as ref_dirichlet
    from repro.data import heartbeat_like as ref_heartbeat
    from repro_torch.data import dirichlet_partition, heartbeat_like

    a = heartbeat_like(np.random.default_rng(7), np.array([5, 0, 3, 2, 1]))
    b = ref_heartbeat(np.random.default_rng(7), np.array([5, 0, 3, 2, 1]))
    assert a.x.tobytes() == b.x.tobytes() and a.y.tobytes() == b.y.tobytes()
    labels = np.random.default_rng(0).integers(0, 4, 200)
    for p, q in zip(
        dirichlet_partition(np.random.default_rng(1), labels, 6),
        ref_dirichlet(np.random.default_rng(1), labels, 6),
    ):
        np.testing.assert_array_equal(p, q)
