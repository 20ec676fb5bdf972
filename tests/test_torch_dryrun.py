"""The dry run on the CPU: one subprocess (``tests/torch_dryrun_main.py``,
no JAX) holding rank 0 of a 16-rank fake process group, a (4, 4) mesh.
``to_placements`` shards a dim over ("data", "model") in the reference's
major-to-minor order; ``lower_pair`` runs the smoke configs of the four
archs of the reference's lowering test, a prefill and a decode pair, each
with the shard shapes its specs imply and the argument bytes its DTensors
hold; the depth extrapolation agrees with full runs; ``dryrun.main``
runs a pair through the CLI."""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_TOL = 0.01  # the extrapolated activation peak's relative error


@pytest.fixture(scope="module")
def result():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(HERE, "..", "src"), HERE]))
    out = subprocess.run([sys.executable, os.path.join(HERE, "torch_dryrun_main.py")], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_placements_follow_the_references_order(result):
    assert len(result["offsets"]) == 32
    for coord, spec, got, want in result["offsets"]:
        assert got == want, (coord, spec)


def test_pairs_run(result):
    kinds = {(p["arch"], p["kind"]) for p in result["pairs"]}
    assert {("qwen3-14b", "train"), ("dbrx-132b", "train"), ("jamba-1.5-large-398b", "train"),
            ("rwkv6-7b", "train"), ("qwen3-14b", "prefill"), ("qwen3-14b", "decode")} == kinds
    for p in result["pairs"]:
        assert p["ok"], p["error"]
        assert p["mesh"] == "4x4"
        mem, rl = p["memory"], p["roofline"]
        assert mem["total_bytes_per_device"] == mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        assert mem["temp_size_in_bytes"] > 0 and rl["flops"] > 0 and rl["bytes"] > 0
        assert rl["dominant"] in ("compute", "memory", "collective")
        assert p["model_flops_token"] > 0 and p["tokens"] > 0
        if p["kind"] == "train":
            assert set(rl["coll_bytes"]) >= {"all-gather", "reduce-scatter"} and all(rl["coll_bytes"].values())
        if p["kind"] == "prefill":
            assert p["attention"].startswith("plain")


def test_shards_are_what_the_specs_imply(result):
    """DTensor's local shard of every parameter has the shape the spec
    arithmetic gives, and a train pair's argument bytes are the shards'
    bytes: parameters, Adam's two fp32 moments and the batch rows."""
    pairs = {p["arch"]: p for p in result["pairs"] if p["kind"] == "train"}
    for arch, s in result["shards"].items():
        assert s["bad"] == [], arch
        from repro_torch.configs import get_smoke_config

        cfg = get_smoke_config(arch)
        itemsize = torch.empty((), dtype=cfg.param_dtype).element_size()
        batch = 2 * (16 // 4) * 256 * 4  # tokens and labels, int32, this rank's 4 of 16 rows
        moments = 2 * s["param_bytes"] * 4 // itemsize
        assert pairs[arch]["memory"]["argument_size_in_bytes"] == s["param_bytes"] + moments + batch


def test_sgd_pair_replicates_its_velocity(result):
    """sgd's velocity, which the specs replicate (the reference's third
    case), is whole on the rank: argument bytes are the parameter shards,
    the whole velocity and the batch rows."""
    r, s = result["sgd"], result["shards"]["qwen3-14b"]
    assert r["ok"], r["error"]
    assert r["memory"]["argument_size_in_bytes"] == s["param_bytes"] + s["whole_bytes"] + 2 * (16 // 4) * 256 * 4


@pytest.mark.parametrize("i", range(2), ids=["dbrx-train", "qwen3-prefill"])
def test_extrapolated_depth_matches_full_runs(result, i):
    """A pair at 4 blocks (grad_accum 4 for train) carried from runs at 1
    and 2 blocks (2 and 3 microbatches) against the same pair run in full:
    FLOPs, bytes and collective bytes exactly, the activation peak to
    PEAK_TOL."""
    ext, full = result["depth"][i]
    assert ext["ok"] and full["ok"], (ext["error"], full["error"])
    assert "extrapolated" in ext["note"] and "extrapolated" not in full["note"]
    a, b = ext["roofline"], full["roofline"]
    assert (a["flops"], a["bytes"]) == (b["flops"], b["bytes"])
    assert a["coll_bytes"] == b["coll_bytes"]
    peak_a, peak_b = ext["memory"]["temp_size_in_bytes"], full["memory"]["temp_size_in_bytes"]
    assert abs(peak_a - peak_b) <= PEAK_TOL * peak_b, (peak_a, peak_b)
    assert ext["memory"]["argument_size_in_bytes"] == full["memory"]["argument_size_in_bytes"]


def test_cli_runs_a_pair(result):
    assert result["cli"]["rc"] == 0
    (r,) = result["cli"]["results"]
    assert (r["arch"], r["shape"], r["ok"], r["kind"]) == ("qwen3-14b", "train_4k", True, "train")
