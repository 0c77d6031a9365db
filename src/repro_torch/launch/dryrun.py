"""Multi-pod dry-run: one sharded step of every (arch x shape x mesh) cell.

Counterpart of ``repro.launch.dryrun``.  Where the reference lowers and
compiles each cell's step for 256 (or 512) fake TPU devices, this runs the
step once on a fake world: a ``fake`` process group of 256 ranks (512 with
``--multi-pod``), the production mesh over it ((32, 8) or (2, 32, 8),
:func:`repro_torch.launch.mesh.make_production_mesh`), and the parameters,
optimizer state, batch and caches as DTensors of fake tensors
(``FakeTensorMode``) placed by ``launch/sharding.py``'s rules.  The step is
the training step (with the reference's auto-microbatching rule), the
prefill or the decode step, run as rank 0 runs it: every local product is
shaped and none is computed, every collective is issued to the fake group
and none moves a byte.  Fake ``cuda`` tensors need no card, and the
dry-run touches none; the port's kernels are custom ops whose fake
implementations give their shapes.

For each cell one dispatch mode (:class:`Watch`) counts rank 0's FLOPs
(``FlopCounterMode``'s formulas), tracks its peak bytes, and records every
collective with its bytes and group (:func:`repro_torch.launch.roofline.
call_record`); the record (the reference's keys: ``arch, shape, mesh,
chips, status, memory, collective_counts, roofline``) goes to a JSON per
cell.
``trace_s`` (the traced run's wall time) takes the place of the
reference's ``lower_s`` and ``compile_s``.

It also dry-runs the paper's own distributed vector-search step
(:func:`repro_torch.core.distributed.dryrun_distributed_search`) on the
same meshes.  This is the only entry point that fakes a world; it runs in
its own process.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
import weakref

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.archs import ARCHS
from repro_torch.configs.shapes import SHAPES, shapes_for
from repro_torch.launch import roofline as rf
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import make_production_mesh, mesh_tag
from repro_torch.models.model import LM
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step

WORLD = 256
PODS_WORLD = 512


def fake_world(world: int) -> None:
    """Make the default process group a fake one of ``world`` ranks (this
    process is rank 0)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world and \
                dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _check_device(device: str) -> None:
    if torch.device(device).type == "cuda" and not torch.backends.cuda.is_built():
        raise SystemExit("fake cuda tensors need a CUDA build of PyTorch "
                         "(no card); on this build pass --device cpu")


def production_mesh(multi_pod: bool, device: str):
    fake_world(PODS_WORLD if multi_pod else WORLD)
    return make_production_mesh(multi_pod=multi_pod, device=device)


def local_bytes(tree) -> int:
    """Bytes of this rank's pieces of every tensor of ``tree``."""
    n = 0
    for t in pytree.tree_leaves(tree):
        t = t.to_local() if isinstance(t, DTensor) else t
        n += t.numel() * t.element_size()
    return n


def microbatches(cfg, shape, mesh) -> int:
    """The reference's auto-microbatching: the remat carry stack is
    L x B_loc x S x d bf16 a rank; split the rank's batch until it stays
    under 2 GiB."""
    dp = 1
    dp_axes = (("pod", "data", "model") if sh.POLICY == "fsdp"
               else ("pod", "data"))
    sizes = sh.axis_sizes(mesh)
    for a in dp_axes:
        dp *= sizes.get(a, 1)
    b_loc = max(1, shape.global_batch // dp)
    carry_gb = (cfg.n_layers * b_loc * shape.seq_len * cfg.d_model
                * 2) / 2 ** 30
    mb = 1
    while carry_gb / mb > 2.0 and mb < b_loc:
        mb *= 2
    return mb


def build_step(arch: str, shape_name: str, mesh, device: str = "cuda",
               cfg=None):
    """(step thunk, argument tree, cfg, shape) of one cell; call inside the
    fake mode.  ``shape_name`` may be a ``ShapeConfig`` and ``cfg``
    overrides ``ARCHS[arch]`` (the tests' smoke widths)."""
    cfg = cfg or ARCHS[arch]
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    lm = LM.abstract(cfg, device=device)
    specs = lm.input_specs(shape)
    sh.distribute_lm(lm, mesh)
    batch = sh.distribute_tree(
        specs["batch"], mesh, sh.batch_shardings(mesh, specs["batch"]))
    params = dict(lm.named_parameters())
    if shape.kind == "train":
        ocfg = opt.OptimizerConfig()
        state = opt.init_state(params)
        step = make_train_step(lm, ocfg,
                               microbatches=microbatches(cfg, shape, mesh))
        return (lambda: step(lm, state, batch)), \
            {"params": params, "opt": state, "batch": batch}, cfg, shape
    if shape.kind == "prefill":
        return (lambda: lm.prefill(batch)), \
            {"params": params, "batch": batch}, cfg, shape
    caches = sh.distribute_tree(
        specs["caches"], mesh,
        sh.cache_shardings(mesh, specs["caches"], shape.global_batch))
    return (lambda: lm.decode_step(batch, specs["pos"], caches)), \
        {"params": params, "batch": batch, "caches": caches}, cfg, shape


class Watch(TorchDispatchMode):
    """One light pass over a step's ops: rank 0's FLOPs (``FlopCounterMode``'s
    formulas), its live and peak bytes (each storage counted once, from the
    op that makes it until its last tensor dies), and its collectives, each
    as a :func:`repro_torch.launch.roofline.call_record`.  (The profiler and
    ``MemTracker`` record every op: ~10^6 events for a full-width training
    step, minutes of tracing.)"""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.live = self.peak = 0
        self._sizes: dict[int, int] = {}
        self._refs: dict[int, int] = {}
        self.records: list[dict] = []

    # ---------------------------------------------------------- memory --
    def _drop(self, key: int) -> None:
        self._refs[key] -= 1
        if self._refs[key] == 0:
            del self._refs[key]
            self.live -= self._sizes.pop(key)

    def _track(self, t: torch.Tensor) -> None:
        if isinstance(t, DTensor):
            t = t._local_tensor
        st = t.untyped_storage()
        key = st._cdata
        if key not in self._sizes:
            self._sizes[key] = st.nbytes()
            self._refs[key] = 0
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
        self._refs[key] += 1
        weakref.finalize(t, self._drop, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rec = rf.call_record(func, list(args) + list(kwargs.values()))
        if rec is not None:
            self.records.append(rec)
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out


def trace(fn):
    """Run ``fn`` once under :class:`Watch`.  Returns (wall seconds, FLOPs,
    the peak bytes of what ``fn`` allocates, the records of its
    collectives): its arguments come on top of that peak."""
    watch = Watch()
    t0 = time.perf_counter()
    with watch:
        fn()
    wall = time.perf_counter() - t0
    return wall, watch.flops, watch.peak, watch.records


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str | None = None, verbose: bool = True,
             device: str = "cuda", mesh=None, cfg=None) -> dict:
    """The record of one cell (``mesh``: another mesh than the production
    one, over the fake world already made).  ``memory`` is rank 0's, in the
    reference's terms: ``argument_size_in_bytes`` (its pieces of the
    parameters, optimizer state, batch and caches), ``temp_size_in_bytes``
    (the step's own peak) and their sum ``peak_size_in_bytes``."""
    _check_device(device)
    mesh = mesh if mesh is not None else production_mesh(multi_pod, device)
    chips = mesh.size()
    with FakeTensorMode(allow_non_fake_inputs=True):
        fn, args, cfg, shape = build_step(arch, shape_name, mesh, device,
                                          cfg)
        arg_bytes = local_bytes(args)
        wall, flops, peak, colls = trace(fn)
    roof = rf.analyze(chips, cfg, shape, colls, flop_count=flops,
                      peak_bytes=peak)
    result = dict(
        arch=arch, shape=shape.name, mesh=mesh_tag(mesh), chips=chips,
        status="ok", trace_s=round(wall, 1),
        memory=dict(argument_size_in_bytes=arg_bytes,
                    temp_size_in_bytes=int(peak),
                    peak_size_in_bytes=arg_bytes + int(peak)),
        collective_counts=rf.count_collectives(colls),
        roofline=roof.report(),
    )
    if verbose:
        print(json.dumps(result, indent=1, default=str))
    _write(out_dir, f"{arch}_{shape.name}_{result['mesh']}", result)
    return result


def _write(out_dir, tag: str, result: dict) -> None:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(result, f, indent=1, default=str)


def run_vector_search_cell(multi_pod: bool, out_dir: str | None = None,
                           device: str = "cuda", **shape) -> dict:
    """Dry-run the paper's distributed sharded-index search step."""
    from repro_torch.core.distributed import dryrun_distributed_search
    _check_device(device)
    mesh = production_mesh(multi_pod, device)
    result = dryrun_distributed_search(mesh, device=device, **shape)
    result["mesh"] = mesh_tag(mesh)
    result["arch"] = "vector-search-distributed"
    print(json.dumps(result, indent=1, default=str))
    _write(out_dir, f"vector-search_{result['mesh']}", result)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--vector-search", action="store_true")
    ap.add_argument("--policy", default="tp_fsdp",
                    choices=["tp_fsdp", "fsdp"])
    ap.add_argument("--remat", default="full", choices=["full", "dots"])
    ap.add_argument("--attn-chunk", type=int, default=0)
    ap.add_argument("--no-causal-block", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (no card is touched)")
    args = ap.parse_args(argv)
    sh.set_policy(args.policy)
    if args.remat == "dots":
        from repro_torch.models import transformer as _tr
        _tr.set_remat_policy("dots")
        rf.TRAIN_FLOP_FACTOR = 3.0
    if args.attn_chunk:
        from repro_torch.models import layers as _ly
        _ly.ATTN_CHUNK = args.attn_chunk
    if args.no_causal_block:
        from repro_torch.models import layers as _ly
        _ly.CAUSAL_BLOCK_UNROLL = 0

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]

    failures = []
    try:
        if args.vector_search:
            for mp in meshes:
                run_vector_search_cell(mp, args.out, args.device)
            return
        if args.all:
            _run_all(args, meshes, failures)
            if failures:
                print(f"# FAILURES: {failures}")
                sys.exit(1)
            return
        run_cell(args.arch, args.shape, args.multi_pod, args.out,
                 device=args.device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _ok_line(r: dict) -> str:
    roof = r["roofline"]
    return (f"OK trace={r['trace_s']}s "
            f"peak={r['memory']['peak_size_in_bytes'] / 2**30:.1f}GiB/rank "
            f"bottleneck={roof['bottleneck']} mfu={roof['roofline_mfu']:.3f}")


def _run_all(args, meshes, failures: list) -> None:
    """Every (arch x shape x mesh) cell in this process, then the search
    cells; a cell that fails goes to ``failures``."""
    for arch, cfg in ARCHS.items():
        for shape_name, s in shapes_for(cfg).items():
            for mp in meshes:
                tag = f"# {arch} x {shape_name} x {'2x32x8' if mp else '32x8'}"
                if s is None:
                    print(f"{tag}: SKIP(full attention)")
                    continue
                try:
                    r = run_cell(arch, shape_name, mp, args.out,
                                 verbose=False, device=args.device)
                    print(f"{tag}: {_ok_line(r)}", flush=True)
                except Exception as e:
                    failures.append((arch, shape_name, mp))
                    print(f"{tag}: FAIL {e}", flush=True)
                    traceback.print_exc()
    for mp in meshes:
        try:
            run_vector_search_cell(mp, args.out, args.device)
        except Exception:
            failures.append(("vector-search", "-", mp))
            traceback.print_exc()


if __name__ == "__main__":
    main()
