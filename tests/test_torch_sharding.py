"""The sharding rules, parameter counts and meta shapes against the
reference's, at all ten configs' published widths, on duck-typed meshes
(no devices, no process group): ``param_specs`` (modes ``tp`` and
``fsdp`` on (4, 4), (16, 16) and (2, 16, 16)), ``cache_specs`` of the 19
decode pairs, ``batch_spec``, ``opt_state_specs``, the HFL specs, the meta
``param_shapes``, ``model_flops_per_token`` / ``active_params`` /
``total_params``, and the hints (``grad_cast``, ``constrain``).  Specs
compare entry for entry."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import get_config as ref_config  # noqa: E402
from repro.distributed import analysis as ref_analysis  # noqa: E402
from repro.distributed import axes as ref_axes  # noqa: E402
from repro.distributed import hfl_mesh as ref_hfl  # noqa: E402
from repro.distributed import sharding as ref_sharding  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro.models.config import INPUT_SHAPES as REF_SHAPES  # noqa: E402
from repro.training import optimizers as ref_opt  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.distributed import analysis, axes, hfl_mesh, sharding  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models.config import INPUT_SHAPES  # noqa: E402
from repro_torch.training import optimizers  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

ARCHS = sorted(ARCH_IDS)


class FakeMesh:
    def __init__(self, **axes):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)


MESHES = {
    "4x4": dict(data=4, model=4),
    "16x16": dict(data=16, model=16),
    "2x16x16": dict(pod=2, data=16, model=16),
}


def _ref_flat(tree, is_spec=False):
    """path string -> leaf of a reference tree (a spec tree's leaves are
    PartitionSpecs)."""
    leaf = (lambda x: isinstance(x, jax.sharding.PartitionSpec)) if is_spec else None
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=leaf)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): v for path, v in flat}


def _port_flat(tree, is_spec=False):
    """path string -> leaf of a port tree (tensors or PartitionSpecs)."""
    out = {}

    def walk(node, prefix):
        if is_spec and isinstance(node, sharding.PartitionSpec) or not is_spec and isinstance(node, torch.Tensor):
            out["/".join(map(str, prefix))] = node
        elif isinstance(node, dict):
            for k in node:
                walk(node[k], prefix + (k,))
        else:
            for i, v in enumerate(node):
                walk(v, prefix + (i,))

    walk(tree, ())
    return out


def _same_specs(want, got):
    want, got = _ref_flat(want, True), _port_flat(got, True)
    assert set(want) == set(got)
    for path in want:
        assert tuple(want[path]) == tuple(got[path]), (path, want[path], got[path])
    return len(want)


@pytest.fixture(scope="module")
def shapes():
    """(reference ShapeDtypeStructs, port meta tensors) per arch."""
    return {a: (ref_specs.param_shapes(ref_config(a)), specs.param_shapes(get_config(a))) for a in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_param_shapes_match_reference(arch, shapes):
    """Paths, shapes and dtypes of the meta tree equal the reference's
    ``eval_shape``; every leaf is meta (nothing drawn, nothing allocated)."""
    want, got = _ref_flat(shapes[arch][0]), _port_flat(shapes[arch][1])
    assert set(want) == set(got)
    for path, w in want.items():
        g = got[path]
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), path


@pytest.mark.parametrize("mode", ["tp", "fsdp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mode, shapes):
    n = 0
    for axes_ in MESHES.values():
        ref_tree = ref_sharding.param_specs(ref_config(arch), shapes[arch][0], mode, FakeMesh(**axes_))
        n += _same_specs(ref_tree, sharding.param_specs(get_config(arch), shapes[arch][1], mode, FakeMesh(**axes_)))
    assert n > 0


DECODE_PAIRS = [(a, s) for a in ARCHS for s, sh in INPUT_SHAPES.items()
                if sh.kind == "decode" and specs.plan(a, s) is not None]


def test_decode_pairs_are_the_references():
    assert len(DECODE_PAIRS) == 19
    assert all(ref_specs.plan(a, s) is not None for a, s in DECODE_PAIRS)


@pytest.mark.parametrize("arch,shape", DECODE_PAIRS)
def test_cache_specs_match_reference(arch, shape):
    rp, p = ref_specs.plan(arch, shape), specs.plan(arch, shape)
    assert p.note == rp.note and p.cfg.sliding_window == rp.cfg.sliding_window
    mesh = FakeMesh(**MESHES["16x16"])
    ref_cache = ref_specs.cache_shapes(rp.cfg, rp.shape)
    cache = specs.cache_shapes(p.cfg, p.shape)
    want, got = _ref_flat(ref_cache), _port_flat(cache)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()} == {
        k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in got.items()}
    _same_specs(ref_sharding.cache_specs(rp.cfg, ref_cache, rp.shape, mesh),
                sharding.cache_specs(p.cfg, cache, p.shape, mesh))


def test_batch_spec_and_input_specs_match_reference():
    for axes_ in MESHES.values():
        for name in INPUT_SHAPES:
            want = ref_sharding.batch_spec(REF_SHAPES[name], FakeMesh(**axes_))
            assert tuple(want) == tuple(sharding.batch_spec(INPUT_SHAPES[name], FakeMesh(**axes_)))
    for arch in ("qwen3-14b", "whisper-tiny"):
        for name in INPUT_SHAPES:
            want, got = ref_specs.input_specs(arch, name), specs.input_specs(arch, name)
            if want is None:
                assert got is None
                continue
            for key in ("batch", "token", "position"):
                if key in want:
                    w, g = _ref_flat(want[key]), _port_flat(got[key])
                    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in w.items()} == {
                        k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in g.items()}


@pytest.mark.parametrize("arch", ["qwen3-14b", "dbrx-132b", "rwkv6-7b"])
def test_opt_state_specs_match_reference(arch, shapes):
    mesh = FakeMesh(**MESHES["16x16"])
    rsds, meta = shapes[arch]
    rspec = ref_sharding.param_specs(ref_config(arch), rsds, "fsdp", mesh)
    pspec = sharding.param_specs(get_config(arch), meta, "fsdp", mesh)
    for name, kw in (("adam", {}), ("sgd", {})):
        r_state = jax.eval_shape(getattr(ref_opt, name)(**kw).init, rsds)
        p_state = getattr(optimizers, name)(**kw).init(meta)
        want = ref_sharding.opt_state_specs(rspec, r_state, rsds)
        got = sharding.opt_state_specs(pspec, p_state, meta)
        assert len(want) == len(got)
        for w, g in zip(want, got):
            _same_specs(w, g)


def test_hfl_specs_match_reference(shapes):
    mesh = FakeMesh(**MESHES["4x4"])
    rsds, meta = shapes["phi3-mini-3.8b"]
    base_r = ref_sharding.param_specs(ref_config("phi3-mini-3.8b"), rsds, "tp", mesh)
    base_p = sharding.param_specs(get_config("phi3-mini-3.8b"), meta, "tp", mesh)
    for edge_axes in (("edge",), ("pod", "edge")):
        _same_specs(ref_hfl.hfl_param_specs(base_r, edge_axes), hfl_mesh.hfl_param_specs(base_p, edge_axes))
        for batch_axes in (("eu",), ("eu", "data")):
            assert tuple(ref_hfl.hfl_batch_spec(edge_axes, batch_axes)) == tuple(
                hfl_mesh.hfl_batch_spec(edge_axes, batch_axes))


def test_hfl_param_specs_on_an_edge_mesh_are_the_replica_layout(shapes):
    """On a 1-D edge mesh every leaf is Shard(0): each rank its E/k
    replicas, the layout ``make_hfl_train_step`` holds."""
    from torch.distributed.tensor import Shard

    mesh = FakeMesh(edge=4)
    base = sharding.param_specs(get_config("phi3-mini-3.8b"), shapes["phi3-mini-3.8b"][1], "tp", mesh)
    for spec in _port_flat(hfl_mesh.hfl_param_specs(base), True).values():
        assert spec[0] == "edge" and all(e is None for e in spec[1:])
        assert sharding.to_placements(spec, mesh) == [Shard(0)]


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_counts_match_reference(arch, shapes):
    rcfg, cfg = ref_config(arch), get_config(arch)
    assert analysis.active_params(cfg) == ref_analysis.active_params(rcfg)
    assert analysis.total_params(cfg) == ref_analysis.total_params(rcfg)
    assert analysis.model_flops_per_token(cfg) == ref_analysis.model_flops_per_token(rcfg)
    if cfg.moe is None and cfg.family not in ("hybrid", "ssm", "encdec"):
        # the dense count is the meta tree's size but for the norms
        n = sum(x.numel() for x in tree_leaves(shapes[arch][1]))
        assert 0.99 < n / analysis.total_params(cfg) < 1.01


def test_roofline_terms():
    rl = analysis.Roofline(989e12, 3.35e12, {"all-reduce": 450e9, "all-gather": 450e9}, 256)
    assert (rl.compute_s, rl.memory_s, rl.collective_s) == pytest.approx((1.0, 1.0, 3.0))
    assert rl.dominant == "collective" and rl.as_dict()["coll_bytes"] == rl.coll_bytes


def test_grad_cast_matches_reference():
    """Forward the identity; the cotangent cast to the dtype, with the
    reference's values (jax.grad through its custom_vjp)."""
    rng = np.random.default_rng(0)
    x, w = rng.standard_normal(7).astype(np.float32), rng.standard_normal(7).astype(np.float32)
    want = jax.grad(lambda x: jnp.sum(ref_axes.grad_cast(x, jnp.bfloat16) * w))(x)
    xt = torch.tensor(x, requires_grad=True)
    y = axes.grad_cast(xt, torch.bfloat16)
    assert torch.equal(y, xt)
    (y * torch.tensor(w)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want, np.float32))

    class Ctx:
        dtype = torch.bfloat16

    assert axes._GradCast.backward(Ctx, torch.tensor(w))[0].dtype == torch.bfloat16
    xt.grad = None
    (axes.grad_cast(xt) * torch.tensor(w)).sum().backward()  # default: x's own dtype
    np.testing.assert_array_equal(xt.grad.numpy(), w)


def test_constrain_without_hints_is_the_identity():
    x = torch.randn(2, 8, 4)
    assert axes.current_hints() == axes.ShardingHints() and axes.kind_spec(x.shape, "tokens") is None
    for kind in ("tokens", "heads", "batch", "state", "nonsense"):
        assert axes.constrain(x, kind) is x
    with axes.sharding_hints(FakeMesh(data=2, model=4)) as h:
        assert (h.batch_axes, h.model_axis, h.batch_size, h.model_size) == (("data",), "model", 2, 4)
        assert axes.constrain(x, "tokens") is x  # a plain tensor passes through
        assert tuple(axes.kind_spec((2, 8, 4), "tokens")) == ("data", "model", None)
        assert tuple(axes.kind_spec((3, 8, 4), "tokens")) == (None, "model", None)  # 3 rows: no batch split
        assert tuple(axes.kind_spec((2, 8, 6, 4), "heads")) == ("data", None, None, None)
    assert axes.current_hints() == axes.ShardingHints()


def test_kind_specs_match_reference_constraints():
    """Every reference kind's spec, as its ``constrain`` builds it, under
    the same hints."""
    seen = {}

    def capture(x, spec):
        seen["spec"] = spec
        return x

    mesh = FakeMesh(pod=2, data=2, model=4)
    cases = {"tokens": (4, 8, 16), "heads": (4, 8, 8, 2), "probs": (4, 8, 3, 3), "inner": (4, 5, 12),
             "ssm": (4, 5, 12, 3), "rwkv5": (4, 8, 2, 2, 3), "kvlogits": (4, 2, 1, 12),
             "dispatch": (4, 5, 8, 2), "experts": (4, 8, 2, 6), "state": (4, 6, 3)}
    orig = jax.lax.with_sharding_constraint
    jax.lax.with_sharding_constraint = capture
    try:
        with ref_axes.sharding_hints(mesh), axes.sharding_hints(mesh):
            for kind, shape in cases.items():
                seen.clear()
                ref_axes.constrain(jnp.zeros(shape), kind)
                assert tuple(seen["spec"]) == tuple(axes.kind_spec(shape, kind)), kind
    finally:
        jax.lax.with_sharding_constraint = orig
