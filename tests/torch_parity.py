"""Helpers shared by the port's parity tests against the JAX package.

The reference draws initial parameters from ``jax.random``, which torch
cannot repeat; ``reference_inits`` makes the port's programs return the
reference's draw for the same seed (the engines seed their
``torch.Generator`` with the run's seed, as the reference seeds its
``PRNGKey``), carried across as numpy arrays.
"""
import contextlib
import dataclasses

import jax
import numpy as np
import pytest

from repro.data.synthetic_health import Dataset as RefDataset
from repro.engine.sync_sim import BatchedSyncEngine as RefBatchedSyncEngine
from repro.federated.client import FLClient as RefFLClient
from repro.federated.programs import CNNProgram as RefCNNProgram
from repro.federated.programs import FedSGDProgram as RefFedSGDProgram
from repro.federated.programs import MLPProgram as RefMLPProgram
from repro.federated.simulation import HFLSimulation as RefHFLSimulation
from repro.federated.simulation import centralized_baseline as ref_centralized_baseline
from repro.models.cnn1d import CNNConfig as RefCNNConfig
from repro.utils.tree import tree_ravel as ref_tree_ravel
from repro_torch.convert import params_from_numpy
from repro_torch.engine.flatten import FlatPack
from repro_torch.federated.programs import CNNProgram, FedSGDProgram, MLPProgram


def reference_program(program):
    """The reference's program of the same config as a port CNN, MLP or
    FedSGD over either."""
    if isinstance(program, FedSGDProgram):
        return RefFedSGDProgram(base=reference_program(program.base), grad_bits=program.grad_bits)
    if isinstance(program, CNNProgram):
        return RefCNNProgram(RefCNNConfig(**dataclasses.asdict(program.cfg)))
    return RefMLPProgram(feat=tuple(program.feat), classes=program.classes, hidden=program.hidden)


class ReferencePopulation:
    """A port scenario's clients, program and test set rebuilt in the
    reference package (the same numpy shards), to run the reference's
    engines on the port's inputs without building its scenario."""

    def __init__(self, sc):
        self.program = reference_program(sc.program)
        self.clients = [
            RefFLClient(c.cid, RefDataset(c.shard.x, c.shard.y, c.shard.n_classes), self.program, **{
                k: getattr(c, k) for k in ("batch_size", "lr", "max_steps", "local_epochs")
            })
            for c in sc.clients
        ]
        self.test = RefDataset(sc.test.x, sc.test.y, sc.test.n_classes)
        self.n_edges = sc.n_edges

    def simulate(self, lam, cloud_rounds, engine="reference", pipeline="device", **kw):
        """The reference's ``HFLSimulation`` or ``BatchedSyncEngine`` run."""
        if engine == "reference":
            sim = RefHFLSimulation(self.clients, lam, self.program, self.test, **kw)
        else:
            sim = RefBatchedSyncEngine(self.clients, lam, self.program, self.test, pipeline=pipeline, **kw)
        return sim.run(cloud_rounds)

    def centralized(self, rounds):
        return ref_centralized_baseline(self.clients, self.program, self.test, rounds, batch=10 * self.n_edges)


def _ref_init(self, generator):
    key = jax.random.PRNGKey(generator.initial_seed())
    return params_from_numpy(jax.tree.map(np.asarray, reference_program(self).init(key)))


@contextlib.contextmanager
def reference_inits():
    """Within the block, ``CNNProgram.init`` and ``MLPProgram.init`` (and so
    ``FedSGDProgram.init`` over either) return the reference's parameters."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CNNProgram, "init", _ref_init)
        mp.setattr(MLPProgram, "init", _ref_init)
        yield


def flat(params) -> np.ndarray:
    """A port parameter tree as one numpy row in the reference's leaf order."""
    return FlatPack(params).ravel(params).detach().cpu().numpy()


def ref_flat(params) -> np.ndarray:
    return np.asarray(ref_tree_ravel(params)[0])


def check_run(want, got, *, acc_tol=1e-6, loss_tol=1e-5, param_tol=5e-3, flat_want=None):
    """Per-round accuracy and mean loss, the accountant's totals and traffic,
    and the final parameters of ``got`` (a port ``SimResult``) against
    ``want`` (a reference ``SimResult``, or a port one with
    ``flat_want=flat``)."""
    assert [m.cloud_round for m in got.history] == [m.cloud_round for m in want.history]
    for mw, mg in zip(want.history, got.history):
        assert mg.test_acc == pytest.approx(mw.test_acc, abs=acc_tol)
        assert mg.mean_local_loss == pytest.approx(mw.mean_local_loss, abs=loss_tol)
    totals = got.accountant.totals()
    assert totals == {k: want.accountant.totals()[k] for k in totals}
    assert got.accountant.eu_traffic_bits() == want.accountant.eu_traffic_bits()
    to_row = flat_want or ref_flat
    np.testing.assert_allclose(flat(got.final_params), to_row(want.final_params), atol=param_tol, rtol=0)
