"""A run with the timed path broken underneath reads ``correct`` false.

Each test skips the look for a chip and drives the rest of a run at a
smoke size with one fault planted in the program: a step that returns
its state unchanged, half of each batch left out (the mean taken over
the rest), an answer altered where it is produced.  (One chip: there is
no exchange between chips to leave out.)"""
from __future__ import annotations

import pytest
import torch

import bench_smoke
from bench import run as bench_run


def _fl_epoch(fault):
    import repro_torch.engine.stream_sim as sim

    orig = sim._cohort_epoch_flat

    def broken(flat, xb, yb, spec, program, n_steps, lr, impl="gemm"):
        if fault == "half_batch":
            half = xb.shape[2] // 2
            return orig(flat, xb[:, :, :half], yb[:, :, :half], spec, program, n_steps, lr, impl)
        _, loss = orig(flat, xb, yb, spec, program, n_steps, lr, impl)
        return flat.detach().clone(), loss

    return sim, "_cohort_epoch_flat", broken


def _fl_eval():
    import repro_torch.engine.stream_sim as sim

    orig = sim.evaluate
    return sim, "evaluate", lambda *a, **k: orig(*a, **k) + 0.01


def _lm_grads(fault):
    import repro_torch.distributed.hfl_mesh as mesh

    orig = mesh._value_and_grad

    def broken(loss_fn, params, batch):
        if fault == "half_batch":
            half = batch["tokens"].shape[-1] // 2
            return orig(loss_fn, params, {k: v[..., :half] for k, v in batch.items()})
        (total, metrics), grads = orig(loss_fn, params, batch)
        if fault == "unchanged":
            return (total, metrics), {k: _zeros(v) for k, v in grads.items()}
        return (total * 1.01, metrics), grads

    return mesh, "_value_and_grad", broken


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_zeros(v) for v in tree)
    return torch.zeros_like(tree)


FAULTS = {
    (bench_smoke.FL_CELL, "unchanged"): lambda: _fl_epoch("unchanged"),
    (bench_smoke.FL_CELL, "half_batch"): lambda: _fl_epoch("half_batch"),
    (bench_smoke.FL_CELL, "answer"): _fl_eval,
    (bench_smoke.LM_CELL, "unchanged"): lambda: _lm_grads("unchanged"),
    (bench_smoke.LM_CELL, "half_batch"): lambda: _lm_grads("half_batch"),
    (bench_smoke.LM_CELL, "answer"): lambda: _lm_grads("answer"),
}


@pytest.mark.parametrize("name,fault", sorted(FAULTS))
def test_fault_reads_incorrect(name, fault, monkeypatch):
    monkeypatch.setattr(*FAULTS[(name, fault)]())
    result = bench_run.execute(bench_smoke.cell(name, seed=17))
    assert result["correct"] is False, result["compared"]


@pytest.mark.parametrize("name", (bench_smoke.FL_CELL, bench_smoke.LM_CELL))
def test_sound_run_reads_correct(name):
    result = bench_run.execute(bench_smoke.cell(name, seed=17))
    assert result["correct"] is True, result["compared"]
