"""Every kernel of the port against its plain version on a CUDA card.

These tests need the card (marker ``cuda``) and skip without one, deciding
in a fixture.  They import neither JAX nor the reference package (the
reference's agreement with the plain versions is held by the CPU tests),
so they run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest tests/test_torch_card.py -m cuda -q
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import (  # noqa: E402
    flash_attention,
    flash_attention_ref,
    hier_aggregate,
    hier_aggregate_ref,
    hier_segment_aggregate,
    hier_segment_aggregate_ref,
    launch_counts,
    reset_launch_counts,
    topk_gating,
    topk_gating_ref,
)
from torch_kernel_replay import aggregate_kernel_replay, segment_kernel_replay  # noqa: E402

pytestmark = pytest.mark.cuda

AGG_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
RAGGED_CASES = [
    # empty segment (2), single-client segment (4)
    (np.array([0, 0, 0, 1, 3, 3, 3, 3, 4]), 5),
    # all clients on one edge
    (np.zeros(9, int), 1),
    # every client its own edge + one empty trailing edge
    (np.arange(9), 10),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(n, d, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((n, d)).astype(np.float32),
        rng.uniform(0.05, 1.0, n).astype(np.float32),
    )


def _f32(t):
    return t.float().cpu().numpy()


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, device) for v in tree)
    return tree.to(device)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("seg,e", RAGGED_CASES + [(np.repeat(np.arange(5), [3, 4, 5, 3, 3]), 5)])
def test_segment_kernel_matches_plain_on_card(cuda, seg, e, dtype):
    tdt, tol = DTYPES[dtype], AGG_TOL[dtype]
    x, w = _inputs(len(seg), 25141)
    u = torch.tensor(x, device=cuda).to(tdt)
    s, wt = torch.tensor(seg, device=cuda), torch.tensor(w, device=cuda)
    reset_launch_counts()
    out = hier_segment_aggregate(u, s, wt, e)
    assert launch_counts()["hier_segment_aggregate"] == 1
    want = hier_segment_aggregate_ref(u, s, wt, e)
    np.testing.assert_allclose(_f32(out), _f32(want), atol=tol, rtol=tol)
    counts = np.bincount(seg, minlength=e)
    for k in np.nonzero(counts == 0)[0]:
        assert bool((out[k] == 0).all())
    for k in np.nonzero(counts == 1)[0]:
        assert torch.equal(out[k], u[int(np.nonzero(seg == k)[0][0])])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize(
    "ids,e,d",
    [(np.array([0, 7, 0, -1, 3, 5, 3, 9, 3]), 5, 25141),  # ids below 0 and at or past E
     (np.arange(21) % 19 - 1, 18, 1000),                  # many segments, int64 ids
     (np.array([2, 2, 0, 1, 2, 40, 2, 2]), 3, 1 << 17),  # large D; 5 members, two batches of loads
     (np.arange(70) * 7 % 13 - 1, 11, 4097)],             # N > 32: ids in three ballots of 32
)
def test_segment_kernel_out_of_range_ids_on_card(cuda, ids, e, d, dtype):
    """On the card an id outside [0, E) belongs to no segment (the TPU
    kernel's one-hot matches none): the kernel agrees with the numpy replay
    of its loop, and the wrapper checks nothing on the card."""
    tdt, tol = DTYPES[dtype], AGG_TOL[dtype]
    x, w = _inputs(len(ids), d, seed=7)
    u = torch.tensor(x, device=cuda).to(tdt)
    s = torch.tensor(ids, device=cuda, dtype=torch.int64 if e > 5 else torch.int32)
    reset_launch_counts()
    out = hier_segment_aggregate(u, s, torch.tensor(w, device=cuda), e)
    assert launch_counts()["hier_segment_aggregate"] == 1
    want = segment_kernel_replay(u.float().cpu().numpy(), ids, w, e)
    np.testing.assert_allclose(_f32(out), want, atol=tol, rtol=tol)


def test_segment_wrapper_never_synchronises_on_card(cuda):
    """The wrapper queues one launch and nothing that waits for the card,
    under sync-debug mode "error" (a synchronising call raises), for int32
    and int64 ids and for weights that need a cast."""
    x, w = _inputs(18, 25141)
    u, wt = torch.tensor(x, device=cuda), torch.tensor(w, device=cuda)
    ids = torch.tensor(np.repeat(np.arange(5), [3, 4, 5, 3, 3]), device=cuda)
    hier_segment_aggregate(u, ids, wt, 5)  # builds and loads the library first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for s, weights in ((ids, wt), (ids.int(), wt), (ids, wt.double())):
            hier_segment_aggregate(u, s, weights, 5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,d", [(1, 25141), (5, 25141), (8, 25141), (9, 4097), (13, 14789), (18, 25141),
                                 (32, 25141), (32, 512), (40, 1000)])
def test_aggregate_kernel_matches_plain_on_card(cuda, n, d, dtype):
    """The kernel against its plain version, and in fp32 bit for bit
    against the numpy replay of its arithmetic: one batch of loads (N <= 8),
    several (9, 13, 18, 32) and two ballots of weights (40)."""
    tdt, tol = DTYPES[dtype], AGG_TOL[dtype]
    x, w = _inputs(n, d)
    u, wt = torch.tensor(x, device=cuda).to(tdt), torch.tensor(w, device=cuda)
    reset_launch_counts()
    out = hier_aggregate(u, wt)
    assert launch_counts()["hier_aggregate"] == 1
    np.testing.assert_allclose(_f32(out), _f32(hier_aggregate_ref(u, wt)), atol=tol, rtol=tol)
    if dtype == "float32":
        np.testing.assert_array_equal(_f32(out), aggregate_kernel_replay(x, w))
    if n == 1:
        assert torch.equal(out, u[0])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n", [1, 5, 9, 40])
def test_aggregate_kernel_zero_total_weight_on_card(cuda, n, dtype):
    """Zero total weight writes zeros, through the 1e-30 clamp."""
    x, _ = _inputs(n, 4097)
    u = torch.tensor(x, device=cuda).to(DTYPES[dtype])
    out = hier_aggregate(u, torch.zeros(n, device=cuda))
    assert torch.equal(out, torch.zeros(4097, dtype=u.dtype, device=cuda))
    assert torch.equal(out, hier_aggregate_ref(u, torch.zeros(n, device=cuda)))


def test_aggregate_wrapper_never_synchronises_on_card(cuda):
    """One call queues one launch and nothing that waits for the card,
    under sync-debug mode "error", for fp32 and bf16 updates and for
    weights that need a cast."""
    x, w = _inputs(5, 25141)
    u, wt = torch.tensor(x, device=cuda), torch.tensor(w, device=cuda)
    hier_aggregate(u, wt)  # builds and loads the library first
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for updates, weights in ((u, wt), (u.to(torch.bfloat16), wt), (u, wt.double())):
            hier_aggregate(updates, weights)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert launch_counts()["hier_aggregate"] == 3


def test_cloud_reduce_never_synchronises_on_card(cuda, monkeypatch):
    """The heartbeat sync engine's cloud reduce, as ``run`` calls it
    (``flat_mean`` on the weights it uploaded once per run), under
    sync-debug mode "error"; the run's accuracy is the CPU run's."""
    from repro_torch.engine import BatchedSyncEngine
    from repro_torch.federated import build_scenario

    sc = build_scenario("heartbeat", scale=0.02, seed=0, n_test_per_class=20, device="cpu")
    lam = sc.assign("eara-sca", device="cpu").lam
    real = BatchedSyncEngine._cloud_mean
    calls = []

    def reduce_without_sync(self, edge_mat, weights):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = real(self, edge_mat, weights)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        calls.append(weights.device)
        return out

    hier_aggregate(torch.ones((2, 8), device=cuda), torch.ones(2, device=cuda))  # builds the library first
    monkeypatch.setattr(BatchedSyncEngine, "_cloud_mean", reduce_without_sync)
    card = sc.simulate(lam, cloud_rounds=2, seed=0, engine="sync", device="cuda")
    assert len(calls) == 2 and all(d.type == "cuda" for d in calls)
    cpu = sc.simulate(lam, cloud_rounds=2, seed=0, engine="sync", device="cpu")
    for a, b in zip(card.history, cpu.history):
        assert abs(a.test_acc - b.test_acc) <= 1.0 / len(sc.test) + 1e-6


def _dual_homed(m, n):
    """Every EU on edge i % n, the first half also on the next edge."""
    asn = np.zeros((m, n))
    asn[np.arange(m), np.arange(m) % n] = 1.0
    asn[: m // 2, (np.arange(m // 2) + 1) % n] = 1.0
    return asn


def _flat_params(res):
    from repro_torch.utils.tree import tree_leaves

    return torch.cat([leaf.reshape(-1).cpu() for leaf in tree_leaves(res.final_params)])


def _card_matches_cpu(card, cpu, n_test):
    """Phase 4's tolerances: accuracy within one test sample, loss 5e-3,
    parameters 5e-3, equal accounting."""
    assert len(card.history) == len(cpu.history)
    for a, b in zip(card.history, cpu.history):
        assert abs(a.test_acc - b.test_acc) <= 1.0 / n_test + 1e-6
        assert abs(a.mean_local_loss - b.mean_local_loss) <= 5e-3
    assert float((_flat_params(card) - _flat_params(cpu)).abs().max()) <= 5e-3
    assert card.accountant.totals() == cpu.accountant.totals()


@pytest.mark.parametrize("kind", ["sca", "dca"])
def test_host_pipeline_on_card_matches_cpu_without_sync(cuda, monkeypatch, kind):
    """The sync engine's host pipeline on the card against the CPU, with
    every ``flat_mean`` call it makes (edge FedAvg, DCA starts, cloud
    reduce) run under sync-debug mode "error": the weights are on the
    device already, and the kernel wrapper never waits for the card.  One
    ``hier_aggregate`` launch per call, and no segment kernel."""
    from repro_torch.engine import sync_sim
    from repro_torch.federated import build_scenario

    sc = build_scenario("heartbeat", scale=0.02, seed=0, n_test_per_class=20, device="cpu")
    lam = sc.assign("eara-sca", device="cpu").lam if kind == "sca" else _dual_homed(len(sc.clients), sc.n_edges)
    real = sync_sim.flat_mean
    calls = []

    def flat_mean_without_sync(updates, weights, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = real(updates, weights, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        calls.append(weights.device)
        return out

    hier_aggregate(torch.ones((2, 8), device=cuda), torch.ones(2, device=cuda))  # builds the library first
    monkeypatch.setattr(sync_sim, "flat_mean", flat_mean_without_sync)
    torch.cuda.synchronize()
    reset_launch_counts()
    card = sc.simulate(lam, cloud_rounds=2, seed=0, engine="sync", pipeline="host", device="cuda")
    torch.cuda.synchronize()
    counts = launch_counts()
    per_edge_round = int((lam.sum(axis=0) > 0).sum()) + int((lam.sum(axis=1) > 1).sum())
    assert counts["hier_aggregate"] == len(calls) == 2 * per_edge_round + 2
    assert counts["hier_segment_aggregate"] == 0
    assert all(d.type == "cuda" for d in calls)
    monkeypatch.undo()
    cpu = sc.simulate(lam, cloud_rounds=2, seed=0, engine="sync", pipeline="host", device="cpu")
    _card_matches_cpu(card, cpu, len(sc.test))


def test_readable_simulator_on_card_matches_cpu_and_launches_no_kernel(cuda):
    """``engine="reference"`` with divergence tracking on the card: the
    same run as on the CPU, and no kernel of the port launches under it."""
    from repro_torch.federated import build_scenario

    sc = build_scenario("heartbeat", scale=0.02, seed=0, n_test_per_class=20, device="cpu")
    lam = _dual_homed(len(sc.clients), sc.n_edges)
    torch.cuda.synchronize()
    reset_launch_counts()
    card = sc.simulate(lam, cloud_rounds=1, seed=4, upp=0.7, track_divergence=True, device="cuda")
    torch.cuda.synchronize()
    assert not any(launch_counts().values())
    cpu = sc.simulate(lam, cloud_rounds=1, seed=4, upp=0.7, track_divergence=True, device="cpu")
    _card_matches_cpu(card, cpu, len(sc.test))
    assert card.history[0].divergence == pytest.approx(cpu.history[0].divergence, rel=1e-3)
    central = [sc.centralized(1, device=d)[0].test_acc for d in ("cuda", "cpu")]
    assert abs(central[0] - central[1]) <= 1.0 / len(sc.test) + 1e-6


@pytest.mark.parametrize("pipeline", ["host", "device"])
@pytest.mark.parametrize("workload", [{"model": "mlp"}, {"fedsgd": True, "grad_bits": 16}], ids=["mlp", "fedsgd-16"])
def test_programs_on_card_match_cpu(cuda, workload, pipeline):
    """The MLP and 16-bit FedSGD programs on both pipelines, card against
    CPU."""
    from repro_torch.federated import build_scenario

    sc = build_scenario("heartbeat", scale=0.02, seed=0, n_test_per_class=20, device="cpu", **workload)
    lam = sc.assign("eara-sca", device="cpu").lam
    runs = [sc.simulate(lam, cloud_rounds=2, seed=1, engine="sync", pipeline=pipeline, device=d) for d in ("cuda", "cpu")]
    _card_matches_cpu(*runs, len(sc.test))


def _true_dual_homed(m, n):
    """Every EU on edge i % n, the first half also on edge (i + 1) % n."""
    asn = np.zeros((m, n))
    asn[np.arange(m), np.arange(m) % n] = 1.0
    half = np.arange(m // 2)
    asn[half, (half + 1) % n] = 1.0
    return asn


@pytest.mark.parametrize("kind,quorum,decay", [("sca", 1.0, 1.0), ("sca", 0.75, 0.5), ("dca", 0.75, 0.5)])
def test_async_on_card_matches_cpu(cuda, kind, quorum, decay):
    """The async engine on the card against the CPU on one latency array:
    the same event sequence, so the same flushes; every weighted average it
    counts (flushes, DCA starts, cloud reduces) is one ``hier_aggregate``
    launch, and the segment kernel never runs."""
    from repro_torch.core import HFLSchedule
    from repro_torch.engine import AsyncHFLEngine
    from repro_torch.federated import build_scenario

    sc = build_scenario("heartbeat", scale=0.02, seed=0, n_test_per_class=20, device="cpu")
    lam = sc.assign("eara-sca", device="cpu").lam if kind == "sca" else _true_dual_homed(len(sc.clients), sc.n_edges)
    runs, engines = [], []
    for d in ("cuda", "cpu"):
        eng = AsyncHFLEngine(sc.clients, lam, sc.program, sc.test, latency=sc.cost.latency,
                             schedule=HFLSchedule(1, 2), seed=1, quorum=quorum, staleness_decay=decay, device=d)
        torch.cuda.synchronize()
        reset_launch_counts()
        runs.append(eng.run(2))
        torch.cuda.synchronize()
        engines.append((eng, launch_counts()))
    (card_eng, card_counts), (cpu_eng, cpu_counts) = engines
    assert card_counts["hier_aggregate"] == sum(card_eng.aggregates.values()) > 0
    assert card_counts["hier_segment_aggregate"] == 0
    assert not any(cpu_counts.values())
    assert card_eng.aggregates == cpu_eng.aggregates and card_eng.flush_rows == cpu_eng.flush_rows
    assert card_eng.weight_uploads == card_eng.aggregates["flush"] + 1
    if kind == "dca":
        assert card_eng.aggregates["dca_start"] > 0
    _card_matches_cpu(*runs, len(sc.test))
    assert runs[0].wall_seconds == runs[1].wall_seconds


def test_topk_compression_on_card_equals_cpu_under_ties(cuda):
    """Top-k on the card keeps exactly the CPU's entries when magnitudes
    tie at the cutoff (a stable sort on CUDA too), row by row and batched;
    ternarization agrees to 1e-6."""
    from repro_torch.core import CompressionSpec
    from repro_torch.engine.flatten import compress_flat_rows

    rng = np.random.default_rng(0)
    base = np.round(rng.standard_normal((6, 25141)) * 3).astype(np.float32) / 8  # many ties
    for kind, tol in (("topk", 0.0), ("ternary", 1e-6)):
        spec = CompressionSpec(kind, fraction=0.05)
        outs = []
        for d in ("cuda", "cpu"):
            starts = torch.zeros((6, 25141), device=d)
            errors = {}
            first = compress_flat_rows(spec, errors, list(range(6)), starts, torch.tensor(base, device=d))
            second = compress_flat_rows(spec, errors, list(range(6)), starts, torch.tensor(base[::-1].copy(), device=d))
            outs.append([first.cpu(), second.cpu()] + [errors[c].cpu() for c in range(6)])
        for a, b in zip(*outs):
            if kind == "topk":
                assert torch.equal(a, b)
            else:
                assert float((a - b).abs().max()) <= tol
        if kind == "topk":
            k = int(np.ceil(25141 * 0.05))
            assert bool(((outs[0][0] != 0).sum(dim=1) == k).all())


def test_sync_device_pipeline_under_faults_on_card(cuda, monkeypatch):
    """The chaos spec on the device pipeline, card against CPU.  The cloud
    weights go to the card once per run; each cloud round's degraded reduce
    (starved edges at weight 0 through the device mask) runs under
    sync-debug mode "error" and uploads nothing."""
    from repro_torch.engine import BatchedSyncEngine
    from repro_torch.faults import FaultSpec
    from repro_torch.federated import build_scenario

    sc = build_scenario("heartbeat", scale=0.02, seed=0, n_test_per_class=20, device="cpu")
    lam = sc.assign("eara-sca", device="cpu").lam
    spec = FaultSpec(seed=3, p_drop=0.25, p_rejoin=0.5, p_fail=0.2, max_retries=2, backoff_s=0.1,
                     energy_uploads=6.0, refade_rounds=1, drift_rate=0.05)
    real_reduce, real_weights = BatchedSyncEngine._cloud_reduce, BatchedSyncEngine._cloud_weights
    reduces, uploads = [], []

    def reduce_without_sync(self, edge_mat, edge_sizes, global_row, g):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = real_reduce(self, edge_mat, edge_sizes, global_row, g)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        reduces.append(edge_sizes.device)
        return out

    def counted_weights(self):
        uploads.append(1)
        return real_weights(self)

    hier_aggregate(torch.ones((2, 8), device=cuda), torch.ones(2, device=cuda))  # builds the library first
    monkeypatch.setattr(BatchedSyncEngine, "_cloud_reduce", reduce_without_sync)
    monkeypatch.setattr(BatchedSyncEngine, "_cloud_weights", counted_weights)
    torch.cuda.synchronize()
    reset_launch_counts()
    card = sc.simulate(lam, cloud_rounds=3, seed=0, engine="sync", faults=spec, device="cuda")
    torch.cuda.synchronize()
    counts = launch_counts()
    assert len(reduces) == 3 and all(d.type == "cuda" for d in reduces) and len(uploads) == 1
    # one segment launch per edge round with a participant, one aggregate
    # launch per cloud round whose hierarchy did not starve
    assert 0 < counts["hier_segment_aggregate"] <= 3 and 0 < counts["hier_aggregate"] <= 3
    monkeypatch.undo()
    cpu = sc.simulate(lam, cloud_rounds=3, seed=0, engine="sync", faults=spec, device="cpu")
    _card_matches_cpu(card, cpu, len(sc.test))
    assert card.accountant.totals()["dropped_uploads"] > 0


VARIANT = {"float32": "simt", "bfloat16": "wgmma"}


def _flash_inputs(cuda, b, s, hq, hkv, d, dtype, seed=3):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal((b, s, h, d)), dtype=torch.float32, device=cuda).to(dtype)
            for h in (hq, hkv, hkv)]


def _flash_launch_checked(q, k, v, variant, **kw):
    """One wrapper call that must launch exactly one kernel, of ``variant``."""
    reset_launch_counts()
    out = flash_attention(q, k, v, **kw)
    assert launch_counts()["flash_attention"] == 1
    assert flash_attention.launches_by_variant == {"wgmma": 0, "simt": 0, variant: 1}
    return out


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize(
    "b,s,hq,hkv,d,window",
    [(1, 128, 4, 4, 64, None), (2, 200, 8, 2, 64, None), (1, 256, 6, 6, 32, 16),
     (2, 130, 4, 1, 128, 100), (1, 1000, 8, 2, 128, 7), (2, 77, 4, 2, 16, None),
     (1, 150, 4, 4, 96, None)],
)
def test_flash_kernel_matches_plain_on_card(cuda, b, s, hq, hkv, d, window, dtype):
    tdt, tol = DTYPES[dtype], FLASH_TOL[dtype]
    q, k, v = _flash_inputs(cuda, b, s, hq, hkv, d, tdt)
    if dtype == "bfloat16" and d < 64:  # no bf16 config has d 16 or 32: the wgmma kernel refuses them
        with pytest.raises(ValueError, match="head dims"):
            flash_attention(q, k, v, window=window)
        return
    out = _flash_launch_checked(q, k, v, VARIANT[dtype], window=window)
    np.testing.assert_allclose(_f32(out), _f32(flash_attention_ref(q, k, v, window=window)), atol=tol, rtol=tol)


@pytest.mark.parametrize("window", [None, 50])
@pytest.mark.parametrize("d", [16, 32, 64, 96, 128])
def test_flash_simt_kernel_every_head_dim_on_card(cuda, d, window):
    """The fp32 kernel at every head dim it is built for, with and without
    a window, a ragged tail past its 128-row query tile, GQA; bitwise
    repeatable; its tile equals ``SIMT_TILE``."""
    from repro_torch.kernels.flash_attention import KERNEL_HEAD_DIMS, SIMT_TILE, simt_kernel_tile

    assert d in KERNEL_HEAD_DIMS and simt_kernel_tile() == SIMT_TILE
    q, k, v = _flash_inputs(cuda, 2, 333, 8, 2, d, torch.float32, seed=d)
    out = _flash_launch_checked(q, k, v, "simt", window=window)
    np.testing.assert_allclose(_f32(out), _f32(flash_attention_ref(q, k, v, window=window)), atol=2e-5, rtol=2e-5)
    assert torch.equal(out, flash_attention(q, k, v, window=window))


def test_flash_simt_kernel_off_grid_view_on_card(cuda):
    """fp32 views whose base or strides are off the 16-byte grid take the
    kernel's 4-byte copies, and agree all the same."""
    base = torch.randn((2, 150, 3 * 64 * 4 + 1), device=cuda)
    qkv = base[:, :, 1:].unflatten(2, (12, 64))  # base 4 bytes past the grid, seq stride odd
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    out = _flash_launch_checked(q, k, v, "simt", window=40)
    np.testing.assert_allclose(_f32(out), _f32(flash_attention_ref(q, k, v, window=40)), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize(
    "b,s,hq,hkv,d,window",
    [(1, 300, 4, 2, 96, None), (2, 300, 8, 1, 96, 50), (1, 1000, 8, 2, 128, 7), (2, 1000, 5, 1, 64, None),
     (3, 77, 4, 2, 128, None), (1, 77, 8, 8, 64, 100), (4, 512, 40, 8, 128, None), (1, 2100, 4, 2, 128, 300)],
)
def test_flash_wgmma_kernel_matches_plain_on_card(cuda, b, s, hq, hkv, d, window):
    """The bf16 wgmma kernel: d 96 (64-byte swizzle), a window below the
    tile, ragged lengths, several stage laps of the ring."""
    q, k, v = _flash_inputs(cuda, b, s, hq, hkv, d, torch.bfloat16, seed=5)
    out = _flash_launch_checked(q, k, v, "wgmma", window=window)
    want = flash_attention_ref(q, k, v, window=window)
    np.testing.assert_allclose(_f32(out), _f32(want), atol=2e-2, rtol=2e-2)
    assert torch.equal(out, flash_attention(q, k, v, window=window))  # no atomics: bitwise repeatable


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_kernel_takes_strided_heads_on_card(cuda, dtype):
    """q, k, v as views of one fused projection, the way a model may hand
    them over: the kernels read them through their strides (TMA maps built
    from them for bf16)."""
    qkv = torch.randn((2, 96, 8 + 2 + 2, 64), device=cuda).to(DTYPES[dtype])
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    out = _flash_launch_checked(q, k, v, VARIANT[dtype])
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(_f32(out), _f32(flash_attention_ref(q, k, v)), atol=tol, rtol=tol)


def test_flash_wgmma_refuses_off_grid_strides_on_card(cuda):
    """A view whose sequence stride is not a multiple of 16 bytes cannot be
    read by TMA: the wrapper raises, and nothing falls back."""
    base = torch.randn((2, 64, 2 * 64 + 4), device=cuda).to(torch.bfloat16)
    q = base[:, :, :128].unflatten(2, (2, 64))  # seq stride 132 elements = 264 bytes
    reset_launch_counts()
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention(q, q[:, :, :1], q[:, :, 1:])
    assert launch_counts()["flash_attention"] == 0


def test_flash_kernel_refuses_head_dim_on_card(cuda):
    q = torch.randn((1, 16, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, q[:, :, :1], q[:, :, :1])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("t,e,k", [(8192, 40, 8), (300, 1000, 8), (33, 33, 3), (7, 1, 1), (64, 64, 70),
                                   (100, 32, 8), (100, 33, 8), (100, 56, 8), (100, 57, 8), (100, 64, 8),
                                   (100, 65, 8), (100, 128, 8),
                                   (50, 1024, 8), (40, 40, 0), (40, 33, 40)])
def test_topk_kernel_matches_plain_on_card(cuda, t, e, k, dtype):
    x = torch.tensor(np.random.default_rng(4).standard_normal((t, e)) * 2, dtype=torch.float32, device=cuda)
    x = x.to(DTYPES[dtype])
    reset_launch_counts()
    out = topk_gating(x, k)
    assert launch_counts()["topk_gating"] == 1
    np.testing.assert_allclose(out.cpu().numpy(), topk_gating_ref(x, k).cpu().numpy(), atol=1e-5, rtol=1e-5)


def test_topk_kernel_ties_and_underflow_on_card(cuda):
    x = torch.zeros((3, 40), device=cuda)
    x[1, ::3] = 1.0
    x[2, 5] = 300.0
    np.testing.assert_array_equal(topk_gating(x, 8).cpu().numpy(), topk_gating_ref(x, 8).cpu().numpy())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("e", [5, 8, 9, 16, 17, 32, 33, 40, 56, 57, 64, 65, 128, 1000])
@pytest.mark.parametrize("k", [1, 2, 8, 40])
def test_topk_kernel_ties_across_slots_on_card(cuda, e, k, dtype):
    """Ties across lanes and register slots (expert l + 32 i sits on lane
    l, slot i, or l + 8 i on a group of 8 lanes for E <= 56), underflow,
    and equal rows: bit for bit the plain version, with the kernel stopping
    at the first sweep whose top is 0.  The last row's sum depends on its
    order, which must be torch.softmax's."""
    x = torch.full((7, e), -200.0, device=cuda)
    x[0, [e - 1, e // 2, 1]] = 0.0
    x[1, [e - 1, min(31, e // 2)]] = 0.0
    x[2, e - 1] = 0.0
    x[3] = 0.0
    x[4, [e - 1, 2]] = 0.0
    x[5, ::3] = 1.0
    x[6] = 0.0
    x[6, ::3] = 1.0
    x = x.to(DTYPES[dtype])
    got = topk_gating(x, k)
    np.testing.assert_array_equal(got.cpu().numpy(), topk_gating_ref(x, k).cpu().numpy())


def test_serving_launches_flash_once_per_layer_on_card(cuda):
    """A uniform prefill with use_flash launches the kernel once per layer;
    decode and the ragged (pad-mask) prefill launch none; and the tokens
    match the CPU run of the same parameters."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.serving import Request, ServeEngine

    cfg = dataclasses.replace(get_smoke_config("qwen3-14b"), use_flash=True)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    on_card = _to(params, cuda)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 40)).astype(np.int32)
    card = ServeEngine(cfg, params=on_card, max_seq=64, device=cuda)
    reset_launch_counts()
    out = [r.out for r in card.run([Request(p, max_new_tokens=6) for p in prompts])]
    assert launch_counts()["flash_attention"] == cfg.n_layers
    assert flash_attention.launches_by_variant == {"wgmma": 0, "simt": cfg.n_layers}  # the smoke config is fp32
    cpu = ServeEngine(cfg, params=params, max_seq=64, device="cpu")
    for a, b in zip(out, (r.out for r in cpu.run([Request(p, max_new_tokens=6) for p in prompts]))):
        np.testing.assert_array_equal(a, b)
    reset_launch_counts()
    card.run([Request(prompts[0][:10], max_new_tokens=3), Request(prompts[1], max_new_tokens=3)])
    assert launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("window", [None, 40])
def test_flash_kernel_non_causal_on_card(cuda, window):
    q, k, v = (torch.randn((2, 100, h, 64), device=cuda) for h in (4, 2, 2))
    out = flash_attention(q, k, v, causal=False, window=window)
    want = flash_attention_ref(q, k, v, causal=False, window=window)
    np.testing.assert_allclose(_f32(out), _f32(want), atol=2e-5, rtol=2e-5)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    out = _flash_launch_checked(qb, kb, vb, "wgmma", causal=False, window=window)
    want = flash_attention_ref(qb, kb, vb, causal=False, window=window)
    np.testing.assert_allclose(_f32(out), _f32(want), atol=2e-2, rtol=2e-2)


# -- streaming populations ------------------------------------------------------
def test_paged_store_on_card_matches_cpu_after_evictions(cuda):
    """Waves of cohorts through a 6-slot paged store on the card gather the
    CPU store's bytes, with the same slots and counters, after evictions."""
    from repro_torch.data import HealthShardSource
    from repro_torch.engine import PagedShardStore

    src = HealthShardSource(2, 40)
    card, cpu = PagedShardStore(src, 6, cuda), PagedShardStore(src, 6, "cpu")
    rng = np.random.default_rng(1)
    for _ in range(8):
        cids = np.sort(rng.choice(40, size=5, replace=False))
        idx = np.stack([rng.integers(0, src.sizes[c], size=(2, 10)) for c in cids])
        (cx, cy), (px, py) = card.gather(cids, idx), cpu.gather(cids, idx)
        assert torch.equal(cx.cpu(), px) and torch.equal(cy.cpu(), py)
        assert (card.hits, card.misses, card.evictions) == (cpu.hits, cpu.misses, cpu.evictions)
    assert card.evictions > 0 and card.device_bytes == cpu.device_bytes


@pytest.mark.parametrize("n,e", [(256, 8)] + [(n, 8) for n in range(33, 41)])
def test_segment_kernel_at_stream_shapes_on_card(cuda, n, e):
    """The streaming engine's edge FedAvg: a cohort of 256 rows into 8
    edges, and N 33-40 (a second ballot of ids), fp32 at 1e-5, one launch."""
    x, w = _inputs(n, 25141, seed=n)
    seg = np.random.default_rng(n).integers(0, e, n)
    u, wt, s = torch.tensor(x, device=cuda), torch.tensor(w, device=cuda), torch.tensor(seg, device=cuda)
    reset_launch_counts()
    out = hier_segment_aggregate(u, s, wt, e)
    assert launch_counts()["hier_segment_aggregate"] == 1
    np.testing.assert_allclose(_f32(out), _f32(hier_segment_aggregate_ref(u, s, wt, e)), atol=1e-5, rtol=1e-5)


def test_aggregate_kernel_at_stream_reduce_on_card(cuda):
    """The streaming engine's cloud reduce: N 8 edges weighted by their data
    sizes, fp32 at 1e-5 and bit for bit against the replay, one launch."""
    x, _ = _inputs(8, 25141, seed=8)
    w = np.random.default_rng(8).integers(100_000, 140_000, 8).astype(np.float32)
    u, wt = torch.tensor(x, device=cuda), torch.tensor(w, device=cuda)
    reset_launch_counts()
    out = hier_aggregate(u, wt)
    assert launch_counts()["hier_aggregate"] == 1
    np.testing.assert_allclose(_f32(out), _f32(hier_aggregate_ref(u, wt)), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(_f32(out), aggregate_kernel_replay(x, w))


def test_stream_round_queues_no_host_sync_on_card(cuda, monkeypatch):
    """``StreamSyncEngine`` on the card: every edge round runs under
    sync-debug mode "error" (the uploads are asynchronous from pinned memory
    and the losses stay on the card), one segment launch per edge round and
    one ``hier_aggregate`` launch per cloud reduce, and the run is the CPU
    run at phase 4's tolerances, paged store and all."""
    from repro_torch.engine import StreamSyncEngine
    from repro_torch.federated import CohortSpec, build_scenario

    sc = build_scenario("heartbeat", lazy=True, n_eus=120, n_edges=4, seed=3, n_test_per_class=20, device="cpu")
    real = StreamSyncEngine._edge_round
    calls = []

    def round_without_sync(self, edge_mat, b, er):
        if self.device.type != "cuda":
            return real(self, edge_mat, b, er)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = real(self, edge_mat, b, er)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        calls.append((b, er))
        return out

    hier_aggregate(torch.ones((2, 8), device=cuda), torch.ones(2, device=cuda))  # builds the library first
    monkeypatch.setattr(StreamSyncEngine, "_edge_round", round_without_sync)
    runs = []
    for d in ("cuda", "cpu"):
        eng = StreamSyncEngine(sc.source, sc.edge_of, sc.program, sc.test, cohort=CohortSpec(size=24, seed=9),
                               n_edges=sc.n_edges, seed=0, page_slots=24, device=d)
        torch.cuda.synchronize()
        reset_launch_counts()
        runs.append(eng.run(3))
        torch.cuda.synchronize()
        counts = launch_counts()
        if d == "cuda":
            assert calls == [(1, 1), (2, 1), (3, 1)]
            assert counts["hier_segment_aggregate"] == 3 and counts["hier_aggregate"] == 3
            assert eng.store.evictions > 0
        else:
            assert not any(counts.values())
    _card_matches_cpu(*runs, len(sc.test))


# -- heterogeneous-model federation ----------------------------------------------
def _mix_scenario():
    from repro_torch.federated import build_scenario

    sc = build_scenario("heartbeat", model_mix={"cnn": 12, "mlp": 6}, scale=0.02, seed=0, n_test_per_class=20,
                        device="cpu")
    return sc, sc.assign("eara-sca", device="cpu").lam


def test_hetero_device_round_queues_no_host_sync_on_card(cuda, monkeypatch):
    """A mixed population (12 CNN EUs, 6 MLP EUs) on the device pipeline:
    every edge round runs under sync-debug mode "error" (two groups'
    cohorts, starts, uploads and segment launches, and no host wait), two
    segment launches per edge round and two ``hier_aggregate`` launches per
    cloud reduce, and the run is the CPU run at phase 4's tolerances."""
    from repro_torch.core import HFLSchedule
    from repro_torch.engine import BatchedSyncEngine

    sc, lam = _mix_scenario()
    real = BatchedSyncEngine._edge_round_device
    calls = []

    def round_without_sync(self, edge_mats):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = real(self, edge_mats)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        calls.append(len(edge_mats))
        return out

    hier_aggregate(torch.ones((2, 8), device=cuda), torch.ones(2, device=cuda))  # builds the library first
    monkeypatch.setattr(BatchedSyncEngine, "_edge_round_device", round_without_sync)
    torch.cuda.synchronize()
    reset_launch_counts()
    card = sc.simulate(lam, cloud_rounds=2, schedule=HFLSchedule(1, 2), engine="sync", device="cuda")
    torch.cuda.synchronize()
    counts = launch_counts()
    assert calls == [2] * 4
    assert counts["hier_segment_aggregate"] == 2 * 4 and counts["hier_aggregate"] == 2 * 2
    assert set(card.final_params) == {"cnn", "mlp"}
    monkeypatch.undo()
    cpu = sc.simulate(lam, cloud_rounds=2, schedule=HFLSchedule(1, 2), engine="sync", device="cpu")
    _card_matches_cpu(card, cpu, len(sc.test))


def test_distill_fuse_flat_on_card_matches_cpu(cuda):
    """The flat fuse at the heartbeat widths (the CNN and the MLP, 5 edges,
    the default spec's 4 steps of 16) on the card against the CPU within
    1e-5, and its losses stay on the card."""
    from repro_torch.engine import DistillSpec, distill_fuse_flat, pack_for
    from repro_torch.federated import CNNProgram, MLPProgram

    progs = [CNNProgram(), MLPProgram()]
    packs = [pack_for(p) for p in progs]
    rng = np.random.default_rng(0)
    mats = [torch.as_tensor(rng.standard_normal((5, pk.dim)) * 0.05, dtype=torch.float32) for pk in packs]
    spec = DistillSpec()
    xb = torch.as_tensor(rng.standard_normal((5, spec.steps, spec.batch, 187, 1)), dtype=torch.float32)
    outs = [distill_fuse_flat(progs, [pk.spec for pk in packs], [m.to(d) for m in mats], xb.to(d), spec)
            for d in (cuda, torch.device("cpu"))]
    (card, card_losses), (cpu, cpu_losses) = outs
    assert all(loss.device.type == "cuda" for loss in card_losses)
    for a, b in zip(card, cpu):
        np.testing.assert_allclose(_f32(a), _f32(b), atol=1e-5, rtol=0)
    np.testing.assert_allclose([float(v) for v in card_losses], [float(v) for v in cpu_losses], rtol=1e-5)


@pytest.mark.parametrize("engine", ["reference", "sync-host", "async"])
def test_hetero_engines_on_card_match_cpu(cuda, engine):
    """One cloud round of the mixed population on the card against the CPU:
    the readable simulator (no kernel launch), the host pipeline (one
    ``hier_aggregate`` per (group, edge) cell with uploads plus one reduce
    per group) and async (its flushes plus one reduce per group)."""
    from repro_torch.engine import AsyncHFLEngine

    sc, lam = _mix_scenario()
    kw = {"reference": {}, "sync-host": {"engine": "sync", "pipeline": "host"}, "async": {"engine": "async"}}[engine]
    torch.cuda.synchronize()
    reset_launch_counts()
    if engine == "async":
        eng = AsyncHFLEngine(sc.clients, lam, sc.program, sc.test, latency=sc.cost.latency,
                             public_shards=sc.public, distill=sc.distill, device="cuda")
        card = eng.run(1)
    else:
        card = sc.simulate(lam, cloud_rounds=1, device="cuda", **kw)
    torch.cuda.synchronize()
    counts = launch_counts()
    group = np.array([0] * 12 + [1] * 6)
    cells = sum(int(((lam[group == g].sum(axis=0)) > 0).sum()) for g in range(2))
    want = {"reference": 0, "sync-host": cells + 2, "async": None}[engine]
    if engine == "async":
        assert counts["hier_aggregate"] == sum(eng.aggregates.values()) == eng.aggregates["flush"] + 2
    else:
        assert counts["hier_aggregate"] == want
    assert counts["hier_segment_aggregate"] == 0
    cpu = sc.simulate(lam, cloud_rounds=1, device="cpu", **kw)
    _card_matches_cpu(card, cpu, len(sc.test))


# -- telemetry ---------------------------------------------------------------------
def test_telemetry_device_round_queues_no_host_sync_on_card(cuda, monkeypatch):
    """A telemetry-on device pipeline on the card: every edge round, its
    spans, metrics and first ``jit_cost`` (a pass on meta tensors) included,
    runs under sync-debug mode "error"; each round record counts 1 segment
    and 1 ``hier_aggregate`` launch; the spans are the CPU run's and the
    run is the CPU run at phase 4's tolerances."""
    from repro_torch.engine import BatchedSyncEngine
    from repro_torch.federated import build_scenario

    sc = build_scenario("heartbeat", scale=0.02, seed=0, n_test_per_class=20, device="cpu")
    lam = sc.assign("eara-sca", device="cpu").lam
    real = BatchedSyncEngine._edge_round_device
    calls = []

    def round_without_sync(self, edge_mats):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = real(self, edge_mats)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        calls.append(len(edge_mats))
        return out

    hier_aggregate(torch.ones((2, 8), device=cuda), torch.ones(2, device=cuda))  # builds the library first
    monkeypatch.setattr(BatchedSyncEngine, "_edge_round_device", round_without_sync)
    card = sc.simulate(lam, cloud_rounds=2, seed=0, engine="sync", device="cuda", telemetry=True)
    assert calls == [1, 1]
    per_round = {"hier_segment_aggregate": 1, "hier_aggregate": 1, "flash_attention": 0, "topk_gating": 0}
    assert [r["kernel_launches"] for r in card.telemetry.rounds] == [per_round] * 2
    monkeypatch.undo()
    cpu = sc.simulate(lam, cloud_rounds=2, seed=0, engine="sync", device="cpu", telemetry=True)
    spans = lambda t: [(s.name, {k: v for k, v in s.attrs.items() if k not in ("acc", "flops", "bytes_moved")})  # noqa: E731
                       for s in t.tracer.spans]
    assert spans(card.telemetry) == spans(cpu.telemetry)
    flops = lambda t: {k: v for k, v in t.metrics.gauges.items() if k.startswith("analytic_flops/")}  # noqa: E731
    assert flops(card.telemetry) == flops(cpu.telemetry)
    _card_matches_cpu(card, cpu, len(sc.test))


def test_wrappers_never_take_the_plain_version_on_card(cuda, monkeypatch):
    """CUDA tensors launch the FedAvg kernels and never reach the plain
    versions (a meta tensor does, and launches nothing)."""
    import importlib

    x, w = _inputs(6, 4097)
    u, wt = torch.as_tensor(x, device=cuda), torch.as_tensor(w, device=cuda)
    seg = torch.as_tensor([0, 1, 1, 2, 0, 2], device=cuda)
    want_agg, want_seg = hier_aggregate_ref(u, wt), hier_segment_aggregate_ref(u, seg, wt, 3)

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor took the plain version")

    for mod, name in (("hier_aggregate", "hier_aggregate_ref"), ("segment_aggregate", "hier_segment_aggregate_ref")):
        monkeypatch.setattr(importlib.import_module(f"repro_torch.kernels.{mod}"), name, refuse)
    torch.cuda.synchronize()
    reset_launch_counts()
    np.testing.assert_allclose(_f32(hier_aggregate(u, wt)), _f32(want_agg), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_f32(hier_segment_aggregate(u, seg, wt, 3)), _f32(want_seg), atol=1e-5, rtol=0)
    assert launch_counts()["hier_aggregate"] == 1 and launch_counts()["hier_segment_aggregate"] == 1
    monkeypatch.undo()
    meta = hier_aggregate(u.to("meta"), wt.to("meta"))
    assert meta.device.type == "meta" and launch_counts()["hier_aggregate"] == 1


def test_moe_decode_launches_topk_gating_once_per_layer_without_sync_on_card(cuda):
    """The granite-moe smoke config on the card: a dense-dispatch prefill
    and each ``decode_step`` launch ``topk_gating`` once per MoE layer, a
    decode step queues no host sync (sync-debug "error"), and the logits
    match the CPU's on the same parameters (1e-4)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.models.transformer import decode_step, prefill

    cfg = get_smoke_config("granite-moe-3b-a800m")
    params = init_params(torch.Generator().manual_seed(0), cfg)
    on_card = _to(params, cuda)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 20)))
    logits, cache = {}, {}
    with torch.inference_mode():
        for dev, p in (("cpu", params), ("cuda", on_card)):
            reset_launch_counts()
            logits[dev], cache[dev] = prefill(p, cfg, tokens.to(dev), max_seq=32)
            assert launch_counts()["topk_gating"] == (cfg.n_layers if dev == "cuda" else 0)
        for step in range(3):
            tok = logits["cpu"].argmax(-1)
            pos = torch.full((3,), 20 + step)
            logits["cpu"], _ = decode_step(params, cfg, tok, cache["cpu"], pos)
            tok_c, pos_c = tok.to(cuda), pos.to(cuda)
            torch.cuda.synchronize()
            reset_launch_counts()
            torch.cuda.set_sync_debug_mode("error")
            try:
                logits["cuda"], _ = decode_step(on_card, cfg, tok_c, cache["cuda"], pos_c)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert launch_counts()["topk_gating"] == cfg.n_layers
            np.testing.assert_allclose(_f32(logits["cuda"]), _f32(logits["cpu"]), atol=1e-4, rtol=0)


def test_moe_engine_round_keeps_one_segment_and_one_aggregate_launch_on_card(cuda):
    """The MoE token population's device-pipeline round on the card: one
    ``hier_segment_aggregate`` and one ``hier_aggregate`` launch a round (no
    ``topk_gating``: training keeps ``router_topk``), and the run matches
    the CPU's."""
    from repro_torch.federated import build_scenario

    sc = build_scenario(model="moe", scale=0.04, seed=0, n_test_per_class=6, lm_eus=5, lm_edges=2, lm_topics=3,
                        lm_seq_len=16, lm_vocab=64, device="cpu")
    lam = sc.assign("eara-sca", device="cpu").lam
    torch.cuda.synchronize()
    reset_launch_counts()
    card = sc.simulate(lam, cloud_rounds=2, seed=3, engine="sync", device="cuda")
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["hier_segment_aggregate"] == 2 and counts["hier_aggregate"] == 2 and counts["topk_gating"] == 0
    cpu = sc.simulate(lam, cloud_rounds=2, seed=3, engine="sync", device="cpu")
    _card_matches_cpu(card, cpu, len(sc.test))


@pytest.mark.parametrize("dispatch", ["moe_mlp", "moe_mlp_serve", "moe_mlp_grouped", "moe_mlp_grouped_reshaped"])
def test_moe_bf16_layer_on_card_matches_cpu(cuda, dispatch):
    """One bf16 MoE layer at granite-moe-3b-a800m's published widths (d
    1536, E 40 top-8, d_ff 512) through each dispatch the transformer runs,
    on the card (bf16 products with fp32 outputs, ``bmm(...,
    out_dtype=)``) and on the CPU (the same products upcast) with the same
    parameters and inputs: outputs within 2e-2 (the bf16 tolerance), the
    fp32 router's aux and z within 1e-5."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config("granite-moe-3b-a800m")
    assert cfg.param_dtype == torch.bfloat16
    params = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((2, 64, cfg.d_model), generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    call = {
        "moe_mlp": lambda p, h: moe.moe_mlp(p, cfg, h),
        "moe_mlp_serve": lambda p, h: (moe.moe_mlp_serve(p, cfg, h),),
        "moe_mlp_grouped": lambda p, h: moe.moe_mlp_grouped(p, cfg, h),
        "moe_mlp_grouped_reshaped": lambda p, h: moe.moe_mlp_grouped(p, cfg, h, group_size=16),
    }[dispatch]
    with torch.inference_mode():
        cpu = call(params, x)
        card = call(_to(params, cuda), x.to(cuda))
    assert card[0].dtype == torch.bfloat16 and card[0].shape == x.shape
    np.testing.assert_allclose(_f32(card[0]), _f32(cpu[0]), atol=2e-2, rtol=0)
    for got, want in zip(card[1:], cpu[1:]):
        assert float(got) == pytest.approx(float(want), abs=1e-5)


RECURRENT = ["jamba-1.5-large-398b", "rwkv6-7b"]


def _recurrent_leaves(cache):
    return [t for c in cache for key, t in c.items() if key not in ("k", "v")]


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_chunked_prefill_equals_stepwise_decode_on_card(cuda, arch):
    """The hybrid (jamba) and ssm (rwkv6) smoke stacks on the card: a
    16-token prefill equals a 1-token prefill followed by 15 decode steps
    over the same tokens (last logits and every recurrent state 1e-4), and
    the chunked prefill's logits match the CPU's on the same parameters
    (1e-4)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.models.transformer import decode_step, prefill

    cfg = get_smoke_config(arch)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    on_card = _to(params, cuda)
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 16)))
    with torch.inference_mode():
        want, want_cache = prefill(on_card, cfg, toks.to(cuda), max_seq=24)
        cpu, _ = prefill(params, cfg, toks, max_seq=24)
        logits, cache = prefill(on_card, cfg, toks[:, :1].to(cuda), max_seq=24)
        for t in range(1, 16):
            logits, cache = decode_step(on_card, cfg, toks[:, t : t + 1].to(cuda), cache,
                                        torch.full((3,), t, device=cuda))
    np.testing.assert_allclose(_f32(want), _f32(cpu), atol=1e-4, rtol=0)
    np.testing.assert_allclose(_f32(logits), _f32(want), atol=1e-4, rtol=0)
    for got, ref in zip(_recurrent_leaves(cache), _recurrent_leaves(want_cache), strict=True):
        np.testing.assert_allclose(_f32(got), _f32(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_decode_advances_state_in_place_on_card(cuda, arch):
    """``init_cache`` on the card gives every recurrent row and layer its
    own zeroed fp32 memory; a ``decode_step`` (queueing no host sync,
    sync-debug "error") writes each layer's new state into the cache it was
    given, and each row of a batch advances as that row alone would (no
    aliased rows: 1e-5)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.models.transformer import decode_step, init_cache, prefill

    cfg = get_smoke_config(arch)
    params = _to(init_params(torch.Generator().manual_seed(1), cfg), cuda)
    leaves = _recurrent_leaves(init_cache(cfg, 3, 12, device=cuda))
    assert all(t.dtype == torch.float32 and t.is_contiguous() and not bool(t.any()) for t in leaves)
    ptrs = {t[l, b].data_ptr() for t in leaves for l in range(t.shape[0]) for b in range(t.shape[1])}
    assert len(ptrs) == sum(t.shape[0] * t.shape[1] for t in leaves)
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 8)), device=cuda)
    with torch.inference_mode():
        logits, cache = prefill(params, cfg, toks, max_seq=12)
        before = [t.clone() for t in _recurrent_leaves(cache)]
        tok, pos = logits.argmax(-1), torch.full((3,), 8, device=cuda)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out, returned = decode_step(params, cfg, tok, cache, pos)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert returned is cache
        assert all(not torch.equal(a, b) for a, b in zip(_recurrent_leaves(cache), before))
        for row in range(3):
            _, c1 = prefill(params, cfg, toks[row : row + 1], max_seq=12)
            one, c1 = decode_step(params, cfg, tok[row : row + 1], c1, pos[:1])
            np.testing.assert_allclose(_f32(out[row]), _f32(one[0]), atol=1e-5, rtol=0)
            for got, ref in zip(_recurrent_leaves(cache), _recurrent_leaves(c1), strict=True):
                np.testing.assert_allclose(_f32(got[:, row]), _f32(ref[:, 0]), atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_bucketed_ragged_batch_equals_solo_on_card(cuda, arch):
    """A ragged batch (lengths 5, 9, 9, 3) on the card goes through one
    exact-length prefill per distinct length: token-identical to each
    request served alone and to the CPU's batch.  With ``use_flash`` the
    jamba stack launches one fp32 flash kernel per attention layer and
    bucket, and ``topk_gating`` once per MoE layer and bucket or step."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.models.transformer import block_spec
    from repro_torch.serving import Request, ServeEngine

    cfg = dataclasses.replace(get_smoke_config(arch), use_flash=True)
    params = init_params(torch.Generator().manual_seed(2), cfg)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (5, 9, 9, 3)]
    new = 6
    card = ServeEngine(cfg, params=_to(params, cuda), max_seq=24, device=cuda)
    torch.cuda.synchronize()
    reset_launch_counts()
    batched = [r.out for r in card.run([Request(p.copy(), max_new_tokens=new) for p in prompts])]
    torch.cuda.synchronize()
    counts = launch_counts()
    specs, n_blocks = block_spec(cfg)
    attn_layers = n_blocks * sum(s.kind == "attn" for s in specs)
    moe_layers = n_blocks * sum(s.is_moe for s in specs)
    assert counts["flash_attention"] == 3 * attn_layers
    assert counts["topk_gating"] == moe_layers * (3 + new - 1)
    cpu = ServeEngine(cfg, params=params, max_seq=24, device="cpu")
    want = [r.out for r in cpu.run([Request(p.copy(), max_new_tokens=new) for p in prompts])]
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(batched[i], want[i])
        np.testing.assert_array_equal(batched[i], card.run([Request(p.copy(), max_new_tokens=new)])[0].out)


# -- encdec serving and LM training on the card ---------------------------------------
def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_to(v, device) for v in tree)
    return tree.to(device)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("use_flash", [False, True])
def test_whisper_smoke_serves_as_on_cpu_on_card(cuda, use_flash):
    """whisper-tiny's smoke config (fp32) with the same parameters and frame
    embeddings: prefill logits 1e-4 and greedy tokens equal to the CPU's,
    uniform and ragged; with ``use_flash`` one fp32 flash launch per decoder
    layer of the uniform prefill, none in the encoder, the decode or the
    pad-mask prefill."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.models.transformer import prefill
    from repro_torch.serving import Request, ServeEngine

    cfg = dataclasses.replace(get_smoke_config("whisper-tiny"), use_flash=use_flash)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    frames = torch.randn((3, cfg.n_audio_frames, cfg.d_model), generator=torch.Generator().manual_seed(2))
    rng = np.random.default_rng(0)
    uniform = list(rng.integers(0, cfg.vocab_size, (3, 40)).astype(np.int32))
    ragged = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (40, 23, 31)]
    logits, outs, launches = {}, {}, {}
    for d in ("cuda", "cpu"):
        p, f = _tree_to(params, d), frames.to(d)
        with torch.inference_mode():
            logits[d] = prefill(p, cfg, torch.as_tensor(np.stack(uniform), device=d), max_seq=cfg.max_seq,
                                enc_embeds=f)[0].cpu()
        eng = ServeEngine(cfg, params=p, max_seq=cfg.max_seq, device=d)
        outs[d] = []
        for batch in (uniform, ragged):
            reset_launch_counts()
            outs[d] += [r.out for r in eng.run([Request(x, max_new_tokens=8) for x in batch], enc_embeds=f)]
            launches[d, len(set(map(len, batch)))] = launch_counts()["flash_attention"]
    assert float((logits["cuda"] - logits["cpu"]).abs().max()) <= 1e-4
    for a, b in zip(outs["cuda"], outs["cpu"], strict=True):
        np.testing.assert_array_equal(a, b)
    assert launches["cuda", 1] == (cfg.n_layers if use_flash else 0)
    assert launches["cuda", 3] == 0 and launches["cpu", 1] == 0


@pytest.mark.parametrize("arch", ["qwen3-14b", "granite-moe-3b-a800m", "whisper-tiny"])
def test_train_step_on_card_matches_cpu(cuda, arch):
    """``make_train_step`` (in-place Adam, ``grad_accum=2``, ``remat=True``)
    for 3 steps on the same parameters and batches: parameters within 5e-4
    of the CPU's (Adam turns 1e-7 gradient differences on near-zero
    gradients into ~1e-4), losses 1e-5; on the card one ``adam_update``
    launch a leaf a step, and no other kernel launch."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.training import adam, init_train_state, make_train_step

    cfg = get_smoke_config(arch)
    params = init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(3):
        t = rng.integers(0, cfg.vocab_size, (4, 17))
        b = {"tokens": torch.as_tensor(t[:, :-1]), "labels": torch.as_tensor(t[:, 1:])}
        if cfg.family == "encdec":
            b["enc_embeds"] = torch.as_tensor(rng.standard_normal((4, cfg.n_audio_frames, cfg.d_model)),
                                              dtype=torch.float32)
        batches.append(b)
    final, losses = {}, {}
    reset_launch_counts()
    for d in ("cuda", "cpu"):
        opt = adam(1e-3)
        state = init_train_state(_tree_to(params, d), opt)
        step = make_train_step(cfg, opt, grad_accum=2, remat=True)
        losses[d] = []
        for b in batches:
            state, m = step(state, {k: v.to(d) for k, v in b.items()})
            losses[d].append(float(m["total_loss"]))
        final[d] = state.params
    counts = launch_counts()
    assert counts.pop("adam_update") == len(batches) * len(_leaves(params)) and not any(counts.values())
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], atol=1e-5, rtol=0)
    for a, b in zip(_leaves(final["cuda"]), _leaves(final["cpu"]), strict=True):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=5e-4, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_round_trip_on_card(cuda, dtype, tmp_path):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.training import load_checkpoint, save_checkpoint

    cfg = dataclasses.replace(get_smoke_config("whisper-tiny"), dtype=dtype)
    tree = init_params(torch.Generator("cuda").manual_seed(3), cfg)
    save_checkpoint(str(tmp_path / "ck.npz"), tree, step=1)
    back = load_checkpoint(str(tmp_path / "ck.npz"), init_params(torch.Generator("cuda").manual_seed(4), cfg))
    for a, b in zip(_leaves(tree), _leaves(back), strict=True):
        assert a.dtype == b.dtype and b.is_cuda and torch.equal(a, b)


def test_kernels_refuse_autograd_on_card(cuda):
    """A CUDA launch writes into a fresh tensor, so under autograd the
    wrappers raise instead of returning an output detached from the graph;
    without grad they launch."""
    gen = torch.Generator("cuda").manual_seed(0)
    q, k, v = (torch.randn((1, 128, 2, 64), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
    logits = torch.randn((4, 40), generator=gen, device="cuda")
    reset_launch_counts()
    with pytest.raises(RuntimeError, match="no gradient"):
        flash_attention(q.requires_grad_(True), k, v)
    with pytest.raises(RuntimeError, match="no gradient"):
        topk_gating(logits.requires_grad_(True), 8)
    assert launch_counts() == {k: 0 for k in launch_counts()}
    with torch.no_grad():
        flash_attention(q, k, v)
        topk_gating(logits, 8)
    assert launch_counts()["flash_attention"] == 1 and launch_counts()["topk_gating"] == 1


@pytest.mark.parametrize("n,e", [(1, 1), (3, 1), (5, 1), (9, 2), (18, 5)])
def test_segment_kernel_at_mesh_rank_shapes_on_card(cuda, n, e):
    """The mesh engine's per-rank edge FedAvg: one heartbeat edge's EUs into
    E 1 (five ranks), two edges a rank, and one rank's 18 into 5; fp32 at
    1e-5, one launch."""
    x, w = _inputs(n, 25141, seed=n)
    seg = np.sort(np.random.default_rng(n).integers(0, e, n))
    u, wt, s = torch.tensor(x, device=cuda), torch.tensor(w, device=cuda), torch.tensor(seg, device=cuda)
    reset_launch_counts()
    out = hier_segment_aggregate(u, s, wt, e)
    assert launch_counts()["hier_segment_aggregate"] == 1
    np.testing.assert_allclose(_f32(out), _f32(hier_segment_aggregate_ref(u, s, wt, e)), atol=1e-5, rtol=1e-5)


def test_mesh_one_rank_is_the_device_pipeline_on_card(cuda):
    """``simulate(pipeline="mesh", mesh=1)`` on the card (a one-rank NCCL
    group): the device pipeline's history and parameters bit for bit, with
    the segment kernel launched once an edge round and ``hier_aggregate``
    once a cloud round, as the device pipeline launches them."""
    from repro_torch.core import HFLSchedule
    from repro_torch.federated import build_scenario
    from repro_torch.utils.tree import tree_leaves

    sc = build_scenario("heartbeat", scale=0.02, seed=0, n_test_per_class=10)
    lam = sc.assign("eara-sca").lam
    runs = {}
    for pipeline in ("device", "mesh"):
        reset_launch_counts()
        res = sc.simulate(lam, 2, engine="sync", pipeline=pipeline, schedule=HFLSchedule(1, 2))
        runs[pipeline] = (res, launch_counts())
    (want, want_counts), (got, counts) = runs["device"], runs["mesh"]
    assert counts == want_counts and counts["hier_segment_aggregate"] == 4 and counts["hier_aggregate"] == 2
    assert [(m.test_acc, m.mean_local_loss) for m in got.history] == [
        (m.test_acc, m.mean_local_loss) for m in want.history]
    for a, b in zip(tree_leaves(got.final_params), tree_leaves(want.final_params), strict=True):
        assert a.is_cuda and torch.equal(a, b)
    assert got.comm_report["cross_edge_total_bytes"] == 0.0


def _one_rank_group(backend="nccl"):
    import torch.distributed as dist

    if not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    assert dist.get_world_size() == 1


@pytest.mark.parametrize("mode", ["tp", "fsdp"])
def test_one_rank_sharded_step_is_the_unsharded_step_on_card(cuda, mode):
    """``make_train_step(param_pspec=)`` on a (1, 1) ("data", "model") mesh
    over a one-rank NCCL group, the state laid out as DTensors: 2 steps of
    the qwen3 smoke config (grad_accum 2) bit for bit the unsharded
    step's; one ``adam_update`` launch a local shard a step, and no other
    kernel launch."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import param_specs
    from repro_torch.models import init_params
    from repro_torch.training import adam, gather_train_state, init_train_state, make_train_step, shard_train_state
    from repro_torch.utils.tree import tree_leaves

    _one_rank_group()
    mesh = DeviceMesh("cuda", [[0]], mesh_dim_names=("data", "model"))
    cfg = get_smoke_config("qwen3-14b")
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(2):
        t = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 17)), device=cuda)
        batches.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    runs = []
    reset_launch_counts()
    for sharded in (False, True):
        params = init_params(torch.Generator("cuda").manual_seed(0), cfg)
        opt = adam(1e-3)
        state = init_train_state(params, opt)
        spec = param_specs(cfg, params, mode, mesh) if sharded else None
        if sharded:
            state = shard_train_state(state, spec, mesh)
        step = make_train_step(cfg, opt, grad_accum=2, param_pspec=spec)
        metrics = []
        for b in batches:
            state, m = step(state, b)
            metrics.append({k: float(v) for k, v in m.items()})
        if sharded:
            state = gather_train_state(state)
        runs.append((metrics, tree_leaves(state.params)))
    assert runs[0][0] == runs[1][0]
    assert all(a.is_cuda and torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1], strict=True))
    counts = launch_counts()
    assert counts.pop("adam_update") == 2 * len(batches) * len(runs[0][1]) and not any(counts.values())


def test_hfl_param_specs_state_syncs_through_hier_aggregate_on_card(cuda):
    """``make_hfl_train_step`` on an edge mesh of one rank with its state
    built by ``DTensor.from_local`` on ``hfl_param_specs``' placements: the
    sync launches ``hier_aggregate`` once a leaf, and each replica after it
    is the kernel's plain version of the replicas the same local step
    leaves (1e-5)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import edge_mesh, hfl_param_specs, init_hfl_state, make_hfl_train_step
    from repro_torch.distributed.sharding import param_specs, to_placements
    from repro_torch.models import init_params
    from repro_torch.training import TrainState, adam
    from repro_torch.training.train_step import _spec_leaves
    from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths, tree_unflatten

    _one_rank_group()
    mesh = edge_mesh(1)
    cfg = get_smoke_config("phi3-mini-3.8b")
    params = init_params(torch.Generator("cuda").manual_seed(0), cfg)
    specs = hfl_param_specs(param_specs(cfg, params, "tp", mesh))
    opt = adam(1e-3)
    t = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 3, 4, 17)), device=cuda)
    batch = {"tokens": t[0, ..., :-1], "labels": t[0, ..., 1:]}
    plain = init_hfl_state(params, opt, 3, mesh=mesh)
    clone = TrainState(tree_map(torch.clone, plain.params), tree_map(torch.clone, plain.opt_state), 0)

    def wrap(tree):
        paths = tree_paths(tree)
        return tree_unflatten(paths, [DTensor.from_local(x, mesh, to_placements(sp, mesh), run_check=False)
                                      for x, sp in zip(tree_leaves(tree), _spec_leaves(specs, paths))])

    state = TrainState(wrap(plain.params), tuple(wrap(o) for o in plain.opt_state), 0)
    reset_launch_counts()
    state, _ = make_hfl_train_step(cfg, opt, sync=True, mesh=mesh)(state, batch)
    torch.cuda.synchronize()
    assert launch_counts()["hier_aggregate"] == len(tree_leaves(state.params))
    local, _ = make_hfl_train_step(cfg, opt, sync=False, mesh=mesh)(clone, batch)  # the same local update
    w = torch.full((3,), 1.0 / 3, device=cuda)
    for got, rep in zip(tree_leaves(state.params), tree_leaves(local.params), strict=True):
        assert isinstance(got, DTensor)
        want = hier_aggregate_ref(rep.reshape(3, -1), w).reshape(rep.shape[1:])
        for r in range(3):
            torch.testing.assert_close(got.to_local()[r], want, atol=1e-5, rtol=1e-5)
