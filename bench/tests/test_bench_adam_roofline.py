"""``adam_roofline``: its byte count from the shapes, its kernel's name,
and its reading on made-up traces."""
from __future__ import annotations

import pytest

import bench_smoke
from bench import harness, roofline

PHI3 = harness.load_json(bench_smoke.ROOT / "bench/configs/phi3-mini-3.8b-hfl5.json")
ADAM = "void (anonymous namespace)::adam_update_kernel<__nv_bfloat16, __nv_bfloat16, float>(__nv_bfloat16*, " \
       "__nv_bfloat16 const*, float*, float*, long, bool, (anonymous namespace)::Coef)"
MANGLED = "_ZN12_GLOBAL__N_118adam_update_kernelI13__nv_bfloat16S1_fEEvPT_PKT0_PT1_S8_lbNS_4CoefE"
OTHERS = (
    "void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::(anonymous namespace)::"
    "FusedAdamMathFunctor<float, 4, (at::native::ADAM_MODE)0, false>>",
    "void aggregate_kernel<c10::BFloat16, 8>(c10::BFloat16 const*, float const*, c10::BFloat16*, long, long)",
    "void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor<float, float, float, "
    "at::native::binary_internal::MulFunctor<float>>>",
)


def _reader(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py", "t_" + name.replace(".", "_"))


def _phi3_leaf_sizes(cfg):
    """The 12 leaves of one replica: the MLP's three (L, d, ff) stacks, the
    attention's four (L, d, d), the two (L, d) norm scales, the input and
    output tables and the final norm."""
    n, d, ff, v = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    return [n * d * ff] * 3 + [n * d * d] * 4 + [n * d] * 2 + [v * d, v * d, d]


def test_phi3_bytes_a_step_by_hand():
    sizes = _phi3_leaf_sizes(PHI3)
    assert len(sizes) == 12 and sum(sizes) == roofline.lm_params(PHI3) == 1_103_023_104
    reader = _reader("adam_roofline")
    # p, g, m, v read once, p, m, v written once: 2 + 2 + 4 + 4 + 2 + 4 + 4 bytes a parameter, 5 replicas
    assert reader.step_bytes(PHI3, sizes, PHI3["edges"]) == 22 * 5 * 1_103_023_104 == 121_332_541_440
    assert reader.step_bytes(PHI3, sizes, PHI3["edges"]) / roofline.PEAK_HBM_BYTES_PER_S == pytest.approx(
        36.2e-3, abs=0.05e-3)


def test_kernel_name_is_told_apart():
    reader = _reader("adam_roofline")
    assert reader.NAME.search(ADAM) and reader.NAME.search(MANGLED)
    assert not any(reader.NAME.search(n) for n in OTHERS)
    for other in ("segment_aggregate_roofline", "hier_aggregate_roofline"):
        assert not _reader(other).NAME.search(ADAM) and not _reader(other).NAME.search(MANGLED)


def _ctx(launches, dur=1e-6, others=()):
    cell = bench_smoke.cell(bench_smoke.LM_CELL)
    cell.config["torch_dtype"] = "bfloat16"
    c = {"leaf_sizes": [100, 200], "edges": 5, "traced_syncs": 1}
    ops = [(ADAM, 1e-3 * i, dur) for i in range(launches)] + [(n, 0.9, 1e-3) for n in others]
    return {"cell": cell, "trace": harness.Trace(1.0, ops, []), "counters": c}


def test_reads_on_a_made_up_trace_at_the_expected_count():
    ctx = _ctx(8 * 5 * 2)  # sync_every 8 steps, 5 edges, 2 leaves
    assert ctx["cell"].traffic["sync_every"] == 8
    got = _reader("adam_roofline").read(ctx)
    want = 100 * (8 * 5 * 300 * 22) / 3.35e12 / (80 * 1e-6)
    assert got == pytest.approx(want) and 0 < got <= 100


@pytest.mark.parametrize("launches, others", [(79, ()), (81, ()), (0, OTHERS)],
                         ids=["one_missing", "one_extra", "none_found"])
def test_no_reading_unless_one_launch_a_leaf_an_edge_a_step(launches, others):
    assert _reader("adam_roofline").read(_ctx(launches, others=others)) is None
