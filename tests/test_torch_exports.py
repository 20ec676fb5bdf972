"""The port's public surface against the reference's: every package's
exported names, every module, and the parameters of every public function
and class, with the deliberate differences named one by one."""
import importlib
import inspect
import pathlib
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
REF = SRC / "repro"
PORT = SRC / "repro_torch"

# reference modules with no port module, and why
NO_MODULE = {
    "distributed/hlo_stats.py": "parses XLA's HLO text; the port counts FLOPs with Telemetry.jit_cost and "
                                "collective bytes with MeshCommLedger and distributed.analysis.CollectiveCounter",
    "kernels/ops.py": "each repro_torch/kernels/<name>.py is its kernel's entry point",
    "kernels/ref.py": "each kernel's wrapper module holds its plain-torch version",
}
# (module, public name) with no port counterpart, and why
JIT = "the port compiles no program per shape: no jit to register or count (its round records carry " \
      "kernel_launches instead)"
NO_NAME = {
    ("distributed.analysis", "roofline_from_compiled"): "torch has no compiled artifact: the dry run builds "
                                                        "Roofline from its own counts",
    **{(m, n): JIT for m in ("telemetry", "telemetry.metrics")
       for n in ("register_jit", "jit_cache_sizes", "registered_jits")},
}
# reference parameters the port does not take, and why
KEY = "key= (a jax.random key) became a torch.Generator"
PALLAS = "the Pallas block sizes and interpret mode have no counterpart in the CUDA kernels"
NO_PARAM = {
    ("distributed.analysis", "collective_bytes", "hlo_text"): "counts a CollectiveCounter, not HLO text",
    ("engine.cohort", "LocalJob", "tag"): "cohort results are keyed by client id, the reference's default tag",
    ("engine.cohort", "make_job", "tag"): "cohort results are keyed by client id, the reference's default tag",
    ("engine.flatten", "flat_mean", "block"): PALLAS,
    ("engine.flatten", "flat_mean", "interpret"): PALLAS,
    ("engine.flatten", "flat_segment_mean", "block"): PALLAS,
    ("engine.flatten", "flat_segment_mean", "interpret"): PALLAS,
    ("engine.mesh_sim", "MeshCommLedger", "devs_per_edge"): "the ledger counts the collectives of its process "
                                                            "group, one rank an edge group",
    ("kernels.flash_attention", "flash_attention", "block_q"): PALLAS,
    ("kernels.flash_attention", "flash_attention", "block_k"): PALLAS,
    ("kernels.flash_attention", "flash_attention", "interpret"): PALLAS,
    ("kernels.hier_aggregate", "hier_aggregate", "block"): PALLAS,
    ("kernels.hier_aggregate", "hier_aggregate", "interpret"): PALLAS,
    ("kernels.segment_aggregate", "hier_segment_aggregate", "block"): PALLAS,
    ("kernels.segment_aggregate", "hier_segment_aggregate", "interpret"): PALLAS,
    ("kernels.topk_gating", "topk_gating", "block_t"): PALLAS,
    ("kernels.topk_gating", "topk_gating", "interpret"): PALLAS,
    ("utils.tree", "TreeSpec", "treedef"): "the port's trees are dicts and tuples, rebuilt from their paths",
    ("utils.tree", "tree_size_bytes", "a"): "named tree",
    ("utils.tree", "tree_num_params", "a"): "named tree",
    **{(m, f, "key"): KEY for m, f in [
        ("models.attention", "attn_init"), ("models.cnn1d", "cnn_init"), ("models.mamba", "mamba_init"),
        ("models.mlp", "mlp_init"), ("models.modules", "dense_init"), ("models.modules", "embedding_init"),
        ("models.moe", "moe_init"), ("models.rwkv", "rwkv_init"), ("models.transformer", "layer_init"),
        ("models.transformer", "init_params"), ("wireless.channel", "sample_topology")]},
}


def _rel_modules():
    return sorted(str(f.relative_to(REF)) for f in REF.rglob("*.py"))


def _name(rel: str) -> str:
    return ".".join(pathlib.Path(rel).with_suffix("").parts).removesuffix("__init__").rstrip(".")


def _public(mod):
    """Its ``__all__``, else its public names but its submodules (which
    other imports set on a package)."""
    names = getattr(mod, "__all__", None)
    if names is not None:
        return set(names)
    return {n for n, v in vars(mod).items() if not n.startswith("_") and not isinstance(v, types.ModuleType)}


@pytest.mark.parametrize("rel", [r for r in _rel_modules() if r.endswith("__init__.py")])
def test_package_exports_match_reference(rel):
    """Every name a reference package exports, the port's exports too."""
    sub = _name(rel)
    ref = importlib.import_module("repro" + ("." + sub if sub else ""))
    port = importlib.import_module("repro_torch" + ("." + sub if sub else ""))
    missing = sorted(n for n in _public(ref) - _public(port) if (sub, n) not in NO_NAME)
    assert not missing, f"repro_torch.{sub} lacks {missing}"


@pytest.mark.parametrize("rel", _rel_modules())
def test_module_and_signatures_match_reference(rel):
    """Every reference module has its port module (but the named ones),
    and each public function or class defined there its namesake taking
    the same parameters (but the named differences)."""
    if rel in NO_MODULE:
        assert not (PORT / rel).exists(), f"{rel} is listed as having no port module"
        return
    assert (PORT / rel).exists(), f"no port of {rel}"
    sub = _name(rel)
    ref = importlib.import_module("repro." + sub if sub else "repro")
    port = importlib.import_module("repro_torch." + sub if sub else "repro_torch")
    for name, obj in vars(ref).items():
        if name.startswith("_") or not callable(obj) or getattr(obj, "__module__", None) != ref.__name__:
            continue
        if (sub, name) in NO_NAME:
            assert not hasattr(port, name), f"{sub}.{name} is listed as having no counterpart"
            continue
        assert hasattr(port, name), f"repro_torch.{sub} lacks {name}"
        try:
            want = inspect.signature(obj).parameters
            got = inspect.signature(getattr(port, name)).parameters
        except (TypeError, ValueError):
            continue
        missing = [p for p in want if p not in got and (sub, name, p) not in NO_PARAM]
        assert not missing, f"repro_torch.{sub}.{name} takes no {missing}"


def test_exceptions_are_still_exceptions():
    """Each named parameter difference still holds (a repaired one must
    leave the list)."""
    for (sub, name, param) in NO_PARAM:
        ref = getattr(importlib.import_module("repro." + sub), name)
        port = getattr(importlib.import_module("repro_torch." + sub), name)
        assert param in inspect.signature(ref).parameters
        assert param not in inspect.signature(port).parameters, (sub, name, param)


def test_queue3_repairs():
    """``encode`` exported, ``tree_zeros_like``, and the recurrent states'
    ``dtype`` (fp32 by default)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import encode  # noqa: F401
    from repro_torch.models.mamba import mamba_init_state
    from repro_torch.models.rwkv import rwkv_init_state
    from repro_torch.utils import tree_zeros_like

    tree = {"a": torch.ones(2, 3, dtype=torch.bfloat16), "b": (torch.ones(4),)}
    z = tree_zeros_like(tree)
    assert z["a"].dtype == torch.bfloat16 and not z["a"].any() and z["b"][0].shape == (4,)
    for fn, arch in ((mamba_init_state, "jamba-1.5-large-398b"), (rwkv_init_state, "rwkv6-7b")):
        cfg = get_smoke_config(arch)
        assert {v.dtype for v in fn(cfg, 2, device="cpu").values()} == {torch.float32}
        assert {v.dtype for v in fn(cfg, 2, torch.bfloat16, device="cpu").values()} == {torch.bfloat16}
