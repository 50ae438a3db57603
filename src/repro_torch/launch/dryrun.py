"""Multi-pod dry run — the port of ``repro.launch.dryrun``: show that every
(arch × input shape × mesh) step runs on the production mesh, and extract the
roofline inputs (FLOPs / HBM bytes / collective bytes / per-rank memory).

The reference forces 512 host devices and lowers each step through XLA. The
port runs each step for real, but on nothing: one CPU process stands in for
every rank through a ``fake`` process group (collectives return at once),
the parameters, optimizer state, inputs and caches are fake tensors
(``FakeTensorMode``: shapes and dtypes, no memory) placed as DTensors by the
sharding rules, and ``launch.costs.step_costs`` counts what the step does.
Fake tensors lie on the CPU, so every kernel op takes its plain version, just
as the reference's dry run never reaches a Pallas kernel.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --multi-pod
    ... --out results.jsonl        # append JSON records
    ... --reduced --mesh 2x4       # smoke scale: reduced configs on a (2, 4) mesh

Exit status 1 if any combination failed (its record says why).
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.tree import path_str, tree_flatten_with_path, tree_leaves, tree_map
from repro_torch.launch import costs as C
from repro_torch.launch.mesh import start_fake_group
from repro_torch.launch.sharding import (
    batch_shardings,
    cache_shardings,
    distribute,
    opt_state_shardings,
    param_shardings,
)
from repro_torch.launch.specs import (
    SHAPES,
    InputShape,
    cache_specs,
    decode_window_override,
    input_specs,
    params_specs,
)
from repro_torch.launch.steps import (
    default_optimizer,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)

FSDP_PARAM_THRESHOLD = 3_000_000_000  # params; above this, weights also shard on data axes
PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def count_params(shapes) -> int:
    return int(sum(math.prod(leaf.shape) for leaf in tree_leaves(shapes)))


def active_param_fraction(cfg, params_shapes) -> float:
    """MoE active fraction for MODEL_FLOPS = 6·N_active·D."""
    if not cfg.num_experts:
        return 1.0
    total = moe = 0.0
    for path, leaf in tree_flatten_with_path(params_shapes)[0]:
        n = float(math.prod(leaf.shape))
        total += n
        p = path_str(path)
        if "/moe/" in p and ("/wi/" in p or "/wg/" in p or "/wo/" in p):
            moe += n
    active = total - moe * (1.0 - cfg.experts_per_token / cfg.num_experts)
    return active / total


def layer_trips(cfg) -> int:
    """The reference's layer-scan trip count, kept for the record: the port
    loops over layers in Python, so its counts need no multiplier."""
    return max(1, cfg.n_layers // len(cfg.pattern))


def fake_mesh(shape: tuple, axes: tuple):
    """A ``DeviceMesh`` of ``shape`` over a fake group of that many ranks
    (restarting the group when its size differs)."""
    world = math.prod(shape)
    if dist.is_initialized() and dist.get_world_size() != world:
        dist.destroy_process_group()
    if not dist.is_initialized():
        start_fake_group(world)
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def _fake_like(tree):
    """Fresh (fake, under ``FakeTensorMode``) CPU tensors shaped like ``tree``'s
    meta leaves."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), tree)


def build_step(cfg, shape: InputShape, mesh, *, fsdp: bool, remat: bool = True,
               microbatches: int = 8):
    """Inside ``FakeTensorMode``: → (fn, args, n_tokens), the arguments
    DTensors placed by the sharding rules (the reference's
    ``build_lowerable``)."""
    p_shapes = params_specs(cfg)
    params = _fake_like(p_shapes)
    p_struct = distribute(params, param_shardings(params, mesh, fsdp=fsdp))
    data = _fake_like(input_specs(cfg, shape))
    d_struct = distribute(data, batch_shardings(data, mesh))

    if shape.kind == "train":
        optimizer = default_optimizer(cfg, count_params(p_shapes))
        opt_state = optimizer.init(params)
        o_struct = distribute(opt_state, opt_state_shardings(opt_state, mesh, fsdp=fsdp))
        fn = make_train_step(cfg, optimizer, remat=remat, microbatches=microbatches)
        n_tokens = data["tokens"].shape[0] * data["tokens"].shape[1]
        return fn, (p_struct, o_struct, d_struct), n_tokens

    if shape.kind == "prefill":
        n_tokens = data["tokens"].shape[0] * data["tokens"].shape[1]
        return make_prefill_step(cfg), (p_struct, d_struct), n_tokens

    # decode: one new token per sequence at the cache's last position
    wo = decode_window_override(cfg, shape)
    cache = _fake_like(cache_specs(cfg, shape, p_shapes))
    c_struct = distribute(cache, cache_shardings(cache, mesh))
    fn = make_serve_step(cfg, window_override=wo)
    return fn, (p_struct, d_struct["token"], c_struct, shape.seq_len - 1), shape.global_batch


def _local_bytes(tree) -> int:
    """Bytes this rank holds of a tree's tensors (a DTensor's local shard)."""
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def _parse_override(kv: str):
    key, _, val = kv.partition("=")
    for cast in (int, float):
        try:
            return key, cast(val)
        except ValueError:
            continue
    if val in ("true", "false"):
        return key, val == "true"
    return key, val


def run_one(arch: str, shape_name: "str | InputShape", *, multi_pod: bool, fsdp: str = "auto",
            remat: bool = True, microbatches: int = 8, overrides: dict | None = None,
            tag: str = "", verbose: bool = True, reduced: bool = False,
            mesh_shape: tuple | None = None) -> dict:
    """One record. ``reduced`` takes the arch's ``reduced()`` config and
    ``mesh_shape`` a smaller mesh (2 dims: ("data", "model"); 3: ("pod",
    "data", "model")), for smoke runs."""
    t0 = time.time()
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    mshape, axes = PRODUCTION_MESHES[multi_pod]
    if mesh_shape is not None:
        mshape = tuple(mesh_shape)
        axes = ("data", "model") if len(mshape) == 2 else ("pod", "data", "model")
    mesh = fake_mesh(mshape, axes)
    chips = math.prod(mshape)

    p_shapes = params_specs(cfg)
    n_params = count_params(p_shapes)
    use_fsdp = (n_params > FSDP_PARAM_THRESHOLD) if fsdp == "auto" else (fsdp == "on")

    with FakeTensorMode(allow_non_fake_inputs=True):
        fn, args, n_tokens = build_step(cfg, shape, mesh, fsdp=use_fsdp, remat=remat,
                                        microbatches=microbatches)
        arg_bytes = _local_bytes(args)
        sc, out = C.step_costs(fn, *args)
        out_bytes = _local_bytes(out)

    coll = C.collective_bytes(sc)
    terms = C.roofline_terms(total_flops=sc.flops, total_bytes=sc.bytes,
                             coll_bytes=coll["total"], chips=chips)
    act_frac = active_param_fraction(cfg, p_shapes)
    mf = (C.model_flops_train if shape.kind == "train" else C.model_flops_infer)(
        n_params, n_tokens, act_frac)
    mesh_name = "x".join(map(str, mshape))
    record = {
        "arch": arch,
        "tag": tag,
        "overrides": overrides or {},
        "microbatches": microbatches,
        "shape": shape.name,
        "mesh": mesh_name,
        "chips": chips,
        "kind": shape.kind,
        "fsdp": use_fsdp,
        "n_params": n_params,
        "active_fraction": round(act_frac, 4),
        "n_tokens": n_tokens,
        "flops_global": sc.flops,
        "bytes_global": sc.bytes,
        "collective_bytes": coll["total"],
        "collectives": {k: v for k, v in coll.items() if k != "total" and v},
        "model_flops": mf,
        "useful_flop_ratio": mf / sc.flops if sc.flops else 0.0,
        "compute_s": terms["compute_s"],
        "memory_s": terms["memory_s"],
        "collective_s": terms["collective_s"],
        "bottleneck": terms["bottleneck"].replace("_s", ""),
        "xla_flops_per_device": sc.local_flops,
        "xla_bytes_per_device": sc.local_bytes,
        "memory_analysis": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            # MemTracker counts a fake DTensor at its global size, so it gives
            # no per-rank peak here: the temporaries are not measured
            "temp_bytes": None,
            "alias_bytes": None,
            "code_bytes": None,
        },
        "compile_seconds": round(time.time() - t0, 1),
        "ok": True,
    }
    if verbose:
        print(f"== {arch} × {shape.name} × {mesh_name} (fsdp={use_fsdp}) ==")
        print(f"  memory_analysis: {record['memory_analysis']}")
        print(f"  per rank: flops={sc.local_flops:.3e} bytes={sc.local_bytes:.3e}")
        print(f"  roofline: compute={terms['compute_s']:.4f}s memory={terms['memory_s']:.4f}s "
              f"collective={terms['collective_s']:.4f}s -> {record['bottleneck']}-bound")
        print(f"  model/counted flop ratio: {record['useful_flop_ratio']:.3f} "
              f"({record['compile_seconds']}s)")
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", choices=[*SHAPES, "all"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--fsdp", default="auto", choices=["auto", "on", "off"])
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (repeatable), e.g. --set moe_dispatch=gather")
    ap.add_argument("--tag", default="", help="label for the record")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--reduced", action="store_true", help="the archs' reduced() configs")
    ap.add_argument("--mesh", default=None,
                    help="a smaller mesh in place of the production one, e.g. 2x4 or 2x2x2")
    args = ap.parse_args(argv)
    overrides = dict(_parse_override(kv) for kv in args.set)
    mesh_shape = tuple(int(d) for d in args.mesh.split("x")) if args.mesh else None

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = 0
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                try:
                    rec = run_one(arch, shape_name, multi_pod=mp, fsdp=args.fsdp,
                                  remat=not args.no_remat, microbatches=args.microbatches,
                                  overrides=overrides, tag=args.tag, reduced=args.reduced,
                                  mesh_shape=mesh_shape)
                except Exception as e:  # noqa: BLE001
                    traceback.print_exc()
                    mesh_name = args.mesh or ("2x16x16" if mp else "16x16")
                    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                           "ok": False, "error": f"{type(e).__name__}: {e}"}
                    failures += 1
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
    if dist.is_initialized():
        dist.destroy_process_group()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
