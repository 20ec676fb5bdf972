"""Helpers shared by the port's parity tests against the JAX package.

The reference draws initial parameters from ``jax.random``, which torch
cannot repeat; ``reference_inits`` makes the port's programs return the
reference's draw for the same seed (the engines seed their
``torch.Generator`` with the run's seed, as the reference seeds its
``PRNGKey``), carried across as numpy arrays.

The fault layer's cost matrices are float32 in both packages, from XLA and
from PyTorch, and may differ in the last bits; ``reference_costs`` makes the
port's ``FaultState.cost`` return the reference's matrices for the same
round, so that an energy or latency threshold cannot flip between the two
runs of a parity test.  Their agreement is held on its own, at rtol 1e-5.
"""
import contextlib
import dataclasses

import jax
import numpy as np
import pytest

from repro.core.compression import CompressionSpec as RefCompressionSpec
from repro.data.synthetic_health import Dataset as RefDataset
from repro.engine.async_sim import AsyncHFLEngine as RefAsyncHFLEngine
from repro.engine.distill import DistillSpec as RefDistillSpec
from repro.engine.sync_sim import BatchedSyncEngine as RefBatchedSyncEngine
from repro.faults import FaultSpec as RefFaultSpec
from repro.faults import FaultState as RefFaultState
from repro.federated.client import FLClient as RefFLClient
from repro.federated.programs import CNNProgram as RefCNNProgram
from repro.federated.programs import FedSGDProgram as RefFedSGDProgram
from repro.federated.programs import LMProgram as RefLMProgram
from repro.federated.programs import MambaProgram as RefMambaProgram
from repro.federated.programs import MLPProgram as RefMLPProgram
from repro.federated.programs import MoEProgram as RefMoEProgram
from repro.federated.programs import RWKVProgram as RefRWKVProgram
from repro.federated.simulation import HeteroHFLSimulation as RefHeteroHFLSimulation
from repro.federated.simulation import HFLSimulation as RefHFLSimulation
from repro.federated.simulation import centralized_baseline as ref_centralized_baseline
from repro.models.cnn1d import CNNConfig as RefCNNConfig
from repro.models.config import ModelConfig as RefModelConfig
from repro.models.config import MoEConfig as RefMoEConfig
from repro.models.config import RWKVConfig as RefRWKVConfig
from repro.models.config import SSMConfig as RefSSMConfig
from repro.utils.tree import tree_ravel as ref_tree_ravel
from repro.wireless.channel import Topology as RefTopology
from repro.wireless.channel import WirelessParams as RefWirelessParams
from repro.wireless.channel import build_cost_matrices as ref_build_cost_matrices
from repro_torch.convert import params_from_numpy
from repro_torch.engine.flatten import FlatPack
from repro_torch.faults import FaultState
from repro_torch.federated.programs import (
    CNNProgram,
    FedSGDProgram,
    LMProgram,
    MambaProgram,
    MLPProgram,
    MoEProgram,
    RWKVProgram,
)


def reference_model_config(cfg) -> RefModelConfig:
    """The reference's ``ModelConfig`` equal to a port one (its ``moe``,
    ``ssm`` and ``rwkv`` blocks included)."""
    fields = dataclasses.asdict(cfg)
    for key, ref_cls in (("moe", RefMoEConfig), ("ssm", RefSSMConfig), ("rwkv", RefRWKVConfig)):
        if fields[key] is not None:
            fields[key] = ref_cls(**fields[key])
    return RefModelConfig(**fields)


def reference_program(program):
    """The reference's program of the same config as a port CNN, MLP, LM,
    MoE, Mamba, RWKV or FedSGD over any of them."""
    if isinstance(program, FedSGDProgram):
        return RefFedSGDProgram(base=reference_program(program.base), grad_bits=program.grad_bits)
    if isinstance(program, CNNProgram):
        return RefCNNProgram(RefCNNConfig(**dataclasses.asdict(program.cfg)))
    for cls, ref_cls in ((LMProgram, RefLMProgram), (MambaProgram, RefMambaProgram), (RWKVProgram, RefRWKVProgram)):
        if isinstance(program, cls):
            return ref_cls(cfg=reference_model_config(program.cfg), seq_len=program.seq_len, n_topics=program.n_topics)
    if isinstance(program, MoEProgram):
        return RefMoEProgram(
            cfg=reference_model_config(program.cfg), seq_len=program.seq_len,
            n_topics=program.n_topics, aux_weight=program.aux_weight, z_weight=program.z_weight,
        )
    return RefMLPProgram(feat=tuple(program.feat), classes=program.classes, hidden=program.hidden)


def _ref_dataset(d):
    return RefDataset(d.x, d.y, d.n_classes)


class ReferencePopulation:
    """A port scenario's clients (each with the reference's program of its
    own), test set, public shards and topology rebuilt in the reference
    package (the same numpy shards and arrays), to run the reference's
    engines on the port's inputs without building its scenario.  ``cost``
    is the reference's cost model of the port's topology: give the port the
    same latency with ``dataclasses.replace(sc, cost=ref.cost)``.  A
    heterogeneous-model population runs the reference's
    ``HeteroHFLSimulation`` as its readable simulator, and every engine
    gets the public shards and the port's ``DistillSpec``."""

    def __init__(self, sc):
        self.program = reference_program(sc.program)
        self.clients = [
            RefFLClient(c.cid, _ref_dataset(c.shard), reference_program(c.program), **{
                k: getattr(c, k) for k in ("batch_size", "lr", "max_steps", "local_epochs")
            })
            for c in sc.clients
        ]
        self.test = _ref_dataset(sc.test)
        self.hetero = sc.is_hetero
        self.public = [_ref_dataset(d) for d in sc.public] if sc.public is not None else None
        self.distill = RefDistillSpec(**dataclasses.asdict(sc.distill)) if sc.distill is not None else None
        self.n_edges = sc.n_edges
        self.topo = RefTopology(**{f.name: getattr(sc.topo, f.name) for f in dataclasses.fields(sc.topo)})
        self.wp = RefWirelessParams(**dataclasses.asdict(sc.wp))
        self.model_bits = sc.model_bits
        self.class_counts = sc.class_counts
        self.cost = ref_build_cost_matrices(self.topo, sc.model_bits, self.wp)

    def fault_state(self, spec):
        """The reference's ``FaultState`` for a port ``FaultSpec``, on the
        port scenario's topology."""
        return RefFaultState(
            RefFaultSpec(**dataclasses.asdict(spec)), self.topo, self.wp, self.model_bits,
            class_counts=self.class_counts,
        )

    def simulate(self, lam, cloud_rounds, engine="reference", pipeline="device", compression=None, faults=None, **kw):
        """The reference's ``HFLSimulation`` (``HeteroHFLSimulation``),
        ``BatchedSyncEngine`` or ``AsyncHFLEngine`` run (the async engine
        takes ``latency=``), given the port's ``CompressionSpec`` and
        ``FaultSpec``."""
        if compression is not None:
            kw["compression"] = RefCompressionSpec(**dataclasses.asdict(compression))
        if faults is not None:
            kw["faults"] = self.fault_state(faults)
        if self.hetero and engine == "reference":
            sim = RefHeteroHFLSimulation(self.clients, lam, self.test, public=self.public, distill=self.distill, **kw)
            return sim.run(cloud_rounds)
        if self.hetero:
            kw.update(public_shards=self.public, distill=self.distill)
        if engine == "reference":
            sim = RefHFLSimulation(self.clients, lam, self.program, self.test, **kw)
        elif engine == "async":
            sim = RefAsyncHFLEngine(self.clients, lam, self.program, self.test, **kw)
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
    """Within the block, the ``init`` of every port program (the CNN, MLP,
    LM, MoE, Mamba and RWKV programs, and so ``FedSGDProgram.init`` over
    any of them) returns the reference's parameters."""
    with pytest.MonkeyPatch.context() as mp:
        for cls in (CNNProgram, MLPProgram, LMProgram, MoEProgram, MambaProgram, RWKVProgram):
            mp.setattr(cls, "init", _ref_init)
        yield


@contextlib.contextmanager
def reference_costs(ref: ReferencePopulation):
    """Within the block, the port's ``FaultState.cost(b)`` returns the
    reference's cost matrices of ``ref``'s topology at round ``b``'s fading
    (which both packages draw byte-equal), energy budgets included."""

    def cost(self, b):
        if b not in self._cost:
            topo_b = dataclasses.replace(ref.topo, fading_mag2=self.fading(b))
            self._cost[b] = ref_build_cost_matrices(topo_b, self.model_bits, ref.wp)
        return self._cost[b]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(FaultState, "cost", cost)
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
