"""The dry run's checks in a process of its own (the fake process group is
global to its process): ``tests/test_torch_dryrun.py`` runs it and reads
the JSON it prints last.  Imports no JAX.

One 16-rank fake group; on a (4, 4) ("data", "model") mesh:

  * ``to_placements`` offsets: rank 0 put at every coordinate of the mesh
    (a permuted mesh tensor) holds the shard the reference's major-to-minor
    order gives, for a dim over ("data", "model") and over one axis;
  * ``lower_pair`` in fsdp on the smoke configs of qwen3-14b, dbrx-132b,
    jamba-1.5-large-398b and rwkv6-7b (train, a small shape), a qwen3
    prefill and a qwen3 decode pair, and a qwen3 train pair with sgd;
    each with the local shard shapes of its parameters and the argument
    bytes the DTensors actually hold;
  * the depth extrapolation: ``lower_pair`` on smoke configs grown to 4
    blocks (dbrx train at grad_accum 4; a qwen3 prefill given grad_accum
    4, which a prefill ignores), with ``extrapolate`` and in full;
  * ``dryrun.main`` on qwen3-14b's train_4k, smoke config, that mesh.
"""
import json
import os
import sys
import tempfile

import torch

torch.set_num_threads(1)

from torch.distributed.device_mesh import DeviceMesh  # noqa: E402
from torch.distributed.tensor import distribute_tensor  # noqa: E402
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed.sharding import P, local_shape, param_specs, to_placements  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.dryrun_lib import fake_group, fake_mode, lower_pair  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.launch.specs import param_shapes  # noqa: E402
from repro_torch.models.config import InputShape  # noqa: E402
from repro_torch.training.train_step import _spec_leaves  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_paths  # noqa: E402

TRAIN = InputShape("train_small", 256, 16, "train")
PREFILL = InputShape("prefill_small", 2048, 8, "prefill")
DECODE = InputShape("decode_small", 2048, 8, "decode")
ARCHS = ("qwen3-14b", "dbrx-132b", "jamba-1.5-large-398b", "rwkv6-7b")


def offsets() -> list:
    """(coordinate, spec, torch's offset, the mixed-radix offset) for rank
    0 placed at each coordinate of a 4 x 4 mesh."""
    out = []
    for i in range(4):
        for j in range(4):
            ids = torch.arange(1, 16)
            grid = torch.cat([ids[:i * 4 + j], torch.zeros(1, dtype=torch.long), ids[i * 4 + j:]]).reshape(4, 4)
            mesh = DeviceMesh("cpu", grid, mesh_dim_names=("data", "model"), _init_backend=False)
            for spec, want in ((P(("data", "model"), None), [(i * 4 + j) * 4, 0]),
                               (P("model", "data"), [j * 16, i * 2])):
                _, got = compute_local_shape_and_global_offset((64, 8), mesh, to_placements(spec, mesh))
                out.append([[i, j], list(spec), list(got), want])
    return out


def shards(arch: str, mesh) -> dict:
    """Each parameter's local shard shape as DTensor lays it out, against
    ``local_shape`` of its spec, and the bytes the shards hold."""
    cfg = get_smoke_config(arch)
    with fake_mode():
        params = param_shapes(cfg)
        specs = param_specs(cfg, params, "fsdp", mesh)
        paths = tree_paths(params)
        held, bad = 0, []
        whole = sum(x.numel() * x.element_size() for x in tree_leaves(params))
        for x, sp in zip(tree_leaves(params), _spec_leaves(specs, paths)):
            full = torch.empty(tuple(x.shape), dtype=x.dtype)
            local = distribute_tensor(full, mesh, to_placements(sp, mesh), src_data_rank=None).to_local()
            if tuple(local.shape) != local_shape(tuple(x.shape), sp, mesh):
                bad.append([list(sp), list(local.shape)])
            held += local.numel() * local.element_size()
    return {"param_bytes": held, "whole_bytes": whole, "bad": bad}


def depth_pairs(mesh) -> list:
    """[extrapolated, full] records of pairs whose smoke config is grown
    to 4 blocks (the extrapolation's smallest case it does not run)."""
    from repro_torch.launch import dryrun_lib

    smoke = dryrun_lib.get_smoke_config
    dryrun_lib.get_smoke_config = lambda arch: dryrun_lib._cut(smoke(arch), 4)
    try:
        return [[lower_pair(arch, shape, mesh, smoke=True, grad_accum=accum, extrapolate=e).as_dict()
                 for e in (True, False)]
                for arch, shape, accum in (("dbrx-132b", TRAIN, 4), ("qwen3-14b", PREFILL, 4))]
    finally:
        dryrun_lib.get_smoke_config = smoke


def main() -> None:
    fake_group(16)
    mesh = make_debug_mesh(4, 4, device="cpu")
    result = {"offsets": offsets(), "pairs": [], "shards": {}}
    for arch, shape in [(a, TRAIN) for a in ARCHS] + [("qwen3-14b", PREFILL), ("qwen3-14b", DECODE)]:
        r = lower_pair(arch, shape, mesh, smoke=True)
        result["pairs"].append(r.as_dict())
    for arch in ARCHS:
        result["shards"][arch] = shards(arch, mesh)
    result["depth"] = depth_pairs(mesh)
    result["sgd"] = lower_pair("qwen3-14b", TRAIN, mesh, smoke=True, optimizer="sgd").as_dict()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "dry.json")
        rc = dryrun.main(["--arch", "qwen3-14b", "--shape", "train_4k", "--smoke", "--device", "cpu",
                          "--mesh", "4x4", "--out", out])
        with open(out) as f:
            result["cli"] = {"rc": rc, "results": json.load(f)}
    sys.stdout.flush()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
