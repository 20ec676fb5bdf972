"""Rank programs of ``tests/test_torch_mesh.py``.

``repro_torch.distributed.run_ranks`` runs them in spawned processes joined
in one gloo group; they import no JAX and nothing of the reference package.
The parent hands them the population as an ``.npz`` and the reference's
initial parameters (converted to the port's tree) as a ``torch.save`` file.
"""
import numpy as np
import torch

from repro_torch.core import HFLSchedule
from repro_torch.data.synthetic_health import Dataset
from repro_torch.engine.flatten import FlatPack
from repro_torch.federated.client import FLClient
from repro_torch.federated.programs import CNNProgram
from repro_torch.models.cnn1d import CNNConfig
from repro_torch.utils.tree import tree_leaves, tree_map

# the reference's engine-bench population used by the mesh tests
POP_M, POP_E = 24, 8
ROUNDS = 2
# mesh_segment_mean's rank check: fixed examples every rank draws alike
SEG_EXAMPLES = 20


def save_population(path, clients, assignment, test, cfg: dict) -> None:
    """Clients' shards, the assignment, the test set and the CNN's config."""
    arrays = {"assignment": np.asarray(assignment), "test_x": test.x, "test_y": test.y,
              "n_classes": np.int64(test.n_classes), **{f"cfg_{k}": np.int64(v) for k, v in cfg.items()}}
    for c in clients:
        arrays[f"x{c.cid}"], arrays[f"y{c.cid}"] = c.shard.x, c.shard.y
    np.savez(path, **arrays)


def load_population(path):
    """(port clients, assignment, test, program) from :func:`save_population`."""
    z = np.load(path)
    program = CNNProgram(CNNConfig(**{k[4:]: int(z[k]) for k in z.files if k.startswith("cfg_")}))
    k = int(z["n_classes"])
    asn = z["assignment"]
    clients = [FLClient(i, Dataset(z[f"x{i}"], z[f"y{i}"], k), program) for i in range(asn.shape[0])]
    return clients, asn, Dataset(z["test_x"], z["test_y"], k), program


def flat(params) -> np.ndarray:
    return FlatPack(params).ravel(params).detach().cpu().numpy()


def summary(res, report=None) -> dict:
    """What the tests compare of one run, as host values."""
    return {
        "accs": [m.test_acc for m in res.history],
        "losses": [m.mean_local_loss for m in res.history],
        "params": flat(res.final_params),
        "totals": res.accountant.totals(),
        "report": report,
    }


def _with_init(init_path):
    params = torch.load(init_path, weights_only=False)
    CNNProgram.init = lambda self, generator: tree_map(torch.clone, params)


def engine_rank(pop_path, init_path, k: int, schedule=(2, 2)) -> dict:
    """``MeshSyncEngine(mesh=k)`` on the population, from the reference's
    initial parameters."""
    from repro_torch.engine import MeshSyncEngine

    _with_init(init_path)
    clients, asn, test, program = load_population(pop_path)
    eng = MeshSyncEngine(clients, asn, program, test, schedule=HFLSchedule(*schedule), seed=0, mesh=k, device="cpu")
    res = eng.run(ROUNDS)
    return summary(res, eng.comm_report())


def segment_examples(n_segments: int):
    """Grid-valued rows, ragged over segments (0 rows included): every
    summation order is exact in float32."""
    for seed in range(SEG_EXAMPLES):
        rng = np.random.default_rng(seed)
        rows = int(rng.integers(0, 25))
        upd = rng.integers(-16, 17, (rows, 5)).astype(np.float32) / 4.0
        seg = rng.integers(0, n_segments, rows)
        w = rng.integers(0, 9, rows).astype(np.float32) / 2.0
        yield upd, seg, w


def segment_mean_numpy(upd, seg, w, n_segments: int) -> np.ndarray:
    want = np.zeros((n_segments, upd.shape[1]), np.float32)
    for s in range(n_segments):
        sel = seg == s
        if sel.any() and w[sel].sum() > 0:
            want[s] = (upd[sel] * w[sel, None]).sum(0) / w[sel].sum()
    return want


def two_rank_extras(pop_path, init_path, hfl_path) -> dict:
    """The two-rank group's work beside its engine run: ``mesh_segment_mean``
    on the fixed examples (largest error against numpy), and the per-edge
    train step, rank ``r`` holding edge ``r`` of E 2."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import edge_mesh, init_hfl_state, make_hfl_train_step
    from repro_torch.engine import mesh_segment_mean
    from repro_torch.training import adam

    out = {"engine": engine_rank(pop_path, init_path, 2)}
    mesh = edge_mesh(2, device="cpu")
    out["segment_err"] = max(
        float(np.abs(mesh_segment_mean(mesh, upd, seg, w, POP_E) - segment_mean_numpy(upd, seg, w, POP_E)).max())
        for upd, seg, w in segment_examples(POP_E)
    )
    hfl = torch.load(hfl_path, weights_only=False)
    cfg, opt = get_smoke_config(hfl["arch"]), adam(1e-3)
    r = mesh.get_local_rank("edge")
    state = init_hfl_state(hfl["params"], opt, 2, mesh=mesh)
    batch = {key: v[r : r + 1] for key, v in hfl["batch"].items()}
    metrics = []
    for sync in (False, True):
        state, m = make_hfl_train_step(cfg, opt, sync=sync, mesh=mesh)(state, batch)
        metrics.append({key: float(v) for key, v in m.items()})
    out["hfl"] = {"params": [x.numpy() for x in tree_leaves(state.params)], "metrics": metrics}
    return out
