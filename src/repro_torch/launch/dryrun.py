"""Multi-pod dry-run launcher.

Runs the train / prefill / decode step of every (architecture x input
shape) once on fake tensors, as one rank of the production meshes:

  single pod : (16, 16)    axes (data, model)          = 256 ranks
  multi-pod  : (2, 16, 16) axes (pod, data, model)     = 512 ranks

and prints per pair its seconds, per-rank memory, FLOPs, collective bytes
and the roofline's dominant term (``launch.dryrun_lib``).  The port of
``repro.launch.dryrun``: the process creates its own ``"fake"`` process
group of the mesh's size (no placeholder devices, no ``XLA_FLAGS``);
``--jobs N`` runs the pairs in N worker processes, each with its own
group; ``--mesh DxM`` takes a small debug mesh.  ``--depth extrapolate``
(the default) runs each step at one and two blocks (a train step of more
than two microbatches at two and three) and carries the counts to the
full pair; ``--depth full`` runs every layer.  ``--smoke`` takes
the smoke configs.  ``--arch`` and ``--shape`` take comma-separated
lists.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--mode fsdp] --jobs 8
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k --smoke --device cpu

``--device`` (default ``cuda``, which needs CUDA) is the device the fake
tensors claim; nothing runs on it.  The exit code is 1 if any pair failed.
"""
import argparse
import json
import sys


def _pair(args, arch: str, shape: str) -> dict:
    """One pair in this process (its fake group made on first use)."""
    from repro_torch.launch.dryrun_lib import fake_group, lower_pair
    from repro_torch.launch.mesh import _size, make_debug_mesh, make_production_mesh

    if args.mesh:
        dims = tuple(int(x) for x in args.mesh.split("x"))
        fake_group(_size(dims) * (2 if args.multi_pod else 1))
        mesh = make_debug_mesh(*dims, multi_pod=args.multi_pod, device=args.device)
    else:
        fake_group(512 if args.multi_pod else 256)
        mesh = make_production_mesh(multi_pod=args.multi_pod, device=args.device)
    res = lower_pair(arch, shape, mesh, sharding_mode=args.mode, optimizer=args.optimizer,
                     remat=not args.no_remat, smoke=args.smoke, extrapolate=args.depth == "extrapolate")
    return res.as_dict()


def _worker(args, pairs, out):
    import torch

    torch.set_num_threads(1)
    for arch, shape in pairs:
        out.put(_pair(args, arch, shape))


def _report(r: dict) -> None:
    tag = "SKIP" if r["kind"] == "skip" else ("OK  " if r["ok"] else "FAIL")
    print(f"[{tag}] {r['arch']:24s} {r['shape']:12s} mesh={r['mesh']} {r['seconds']:6.1f}s {r['note']}")
    if r["ok"] and r["memory"] and r["roofline"]:
        gb = r["memory"].get("total_bytes_per_device", 0) / 2**30
        rl = r["roofline"]
        print(f"       mem/dev={gb:.2f} GiB  flops={rl.get('flops', 0):.3e}"
              f"  coll={sum(rl.get('coll_bytes', {}).values()):.3e}B  dominant={rl.get('dominant')}")
    if not r["ok"]:
        print("       " + r["error"].splitlines()[0])
    sys.stdout.flush()


def run(args) -> int:
    from repro_torch.configs import list_archs
    from repro_torch.device import resolve_device
    from repro_torch.models.config import INPUT_SHAPES

    resolve_device(args.device)
    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    shapes = list(INPUT_SHAPES) if args.shape == "all" else args.shape.split(",")
    pairs = [(a, s) for a in archs for s in shapes]
    results = []
    if args.jobs <= 1:
        for arch, shape in pairs:
            results.append(_pair(args, arch, shape))
            _report(results[-1])
            _write(args, results)
    else:
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        out = ctx.Queue()
        procs = [ctx.Process(target=_worker, args=(args, pairs[i::args.jobs], out)) for i in range(args.jobs)]
        for p in procs:
            p.start()
        try:
            for _ in pairs:
                results.append(out.get())
                _report(results[-1])
                _write(args, results)
        finally:
            for p in procs:
                p.join(5)
                if p.is_alive():
                    p.kill()
    failed = sum(1 for r in results if not r["ok"])
    print(f"\n{len(results) - failed}/{len(results)} pairs ran OK")
    return 1 if failed else 0


def _write(args, results) -> None:
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="architecture ids (comma-separated) or 'all'")
    ap.add_argument("--shape", default="all", help="input shape names (comma-separated) or 'all'")
    ap.add_argument("--all", action="store_true", help="every arch and shape not named (the defaults)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mode", default="fsdp", choices=["tp", "fsdp"])
    ap.add_argument("--optimizer", default="adam", choices=["adam", "sgd"])
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--out", default="")
    ap.add_argument("--depth", default="extrapolate", choices=["extrapolate", "full"])
    ap.add_argument("--smoke", action="store_true", help="the smoke configs (CPU tests)")
    ap.add_argument("--jobs", type=int, default=1, help="worker processes, each its own fake group")
    ap.add_argument("--device", default="cuda", help="the device the fake tensors claim (cuda or cpu)")
    ap.add_argument("--mesh", default="", help="a DxM debug mesh (make_debug_mesh) for the production one")
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
