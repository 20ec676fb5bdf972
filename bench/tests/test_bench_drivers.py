"""Both drivers against the plain reference at smoke sizes on the CPU:
the program passes every limit, the reference in the control's lower
precision and each planted fault fail at least one."""
from __future__ import annotations

import pytest
import torch

import bench_smoke
from bench import harness

CELLS = (bench_smoke.FL_CELL, bench_smoke.LM_CELL)


@pytest.mark.parametrize("name", CELLS)
def test_program_passes_its_limits(name):
    cell = bench_smoke.cell(name)
    out = harness.driver_of(cell).run(cell)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["checks"] and all(harness.passes(c) for c in out["checks"]), out["checks"]
    assert set(out["e2e"]) == {m["name"] for m in harness.metrics_for(cell, "end_to_end")}


@pytest.mark.parametrize("name", CELLS)
def test_lower_precision_and_faults_fail(name):
    cell = bench_smoke.cell(name, seed=11)
    variants = ("control", "unchanged", "half_batch", "answer")
    got = harness.driver_of(cell).calibrate(cell, variants)
    limits = cell.limits

    def fails(reading):
        return any(not harness.passes(harness.check(k, v, limits[k])) for k, v in reading.items())

    assert not fails(got["program"]), got["program"]
    for v in variants:
        assert fails(got[v]), (v, got[v])


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_lower_precision_fails_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control's TF32 and the cell's kernels run only there")
    cell = bench_smoke.cell(name, seed=13)
    cell.device = "cuda"
    got = harness.driver_of(cell).calibrate(cell, ("control",))
    assert any(v > cell.limits[k] for k, v in got["control"].items()), got
    assert all(v <= cell.limits[k] for k, v in got["program"].items()), got


@pytest.mark.parametrize("change", ({"hidden_act": "gelu_pytorch_tanh"},
                                    {"rms_norm_eps": None, "layer_norm_eps": 1e-5},
                                    {"architectures": ["Qwen2ForCausalLM"]}))
def test_lm_configuration_beyond_the_reference_is_refused(change):
    """A configuration whose activation, norm or block the driver and the
    reference do not implement raises on both sides instead of running as
    a SwiGLU/RMSNorm decoder."""
    from bench.drivers import hfl_train
    from bench.reference import lm as ref_lm

    cfg = dict(bench_smoke.cell(bench_smoke.LM_CELL).config)
    cfg.update(change)
    cfg = {k: v for k, v in cfg.items() if v is not None}
    with pytest.raises(NotImplementedError):
        ref_lm.Decoder(cfg)
    if "architectures" not in change:
        with pytest.raises(NotImplementedError):
            hfl_train.model_config(cfg)


def test_tf32_control_rounds_both_directions():
    """The FL control's products take TF32 operands forward and backward:
    the gradient reaching a weight is an exact product of TF32 values."""
    from bench.reference import fl as ref_fl

    gen = torch.Generator().manual_seed(3)
    a = torch.randn(6, 5, generator=gen, dtype=torch.float32)
    w = torch.randn(5, 4, generator=gen, dtype=torch.float32, requires_grad=True)
    g = torch.randn(6, 4, generator=gen, dtype=torch.float32)
    y = ref_fl._product(ref_fl._tf32(a, True) @ ref_fl._tf32(w, True), True)
    (gw,) = torch.autograd.grad(y, w, g)
    want = ref_fl._round_tf32(a).double().t() @ ref_fl._round_tf32(g).double()
    assert torch.allclose(gw.double(), want, rtol=1e-6, atol=0)
    assert not torch.allclose(gw.double(), a.double().t() @ g.double(), rtol=1e-6, atol=0)
    assert torch.equal(ref_fl._round_tf32(ref_fl._round_tf32(a)), ref_fl._round_tf32(a))
