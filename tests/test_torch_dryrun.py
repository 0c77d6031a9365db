"""The port's dry-run (``repro_torch.launch.dryrun``) on a fake world.

A ``fake`` process group of 16 ranks, a 4 x 4 (data, model) mesh over it,
and the smoke widths of gemma-2b, dbrx-132b (MoE), mamba2-1.3b (SSM) and
llama-3.2-vision-11b (cross attention), at a small train, prefill and
decode shape:

* every cell's sharded step runs on fake tensors (``status == "ok"``);
* rank 0's FLOP count times the world lies between ``model_flops_for`` and
  3 x ``analytic_flops``, the reference's own band (``test_roofline.py``):
  wide, since a leaf that does not divide an axis (2 KV heads on a model
  axis of 4) computes replicated, and the smoke configs train without
  remat;
* a sharded cell records its collectives, the model axis' on NVLink;
* rank 0's argument bytes are at most the one-rank total / 4 plus the
  replicated leaves;
* ``dryrun_distributed_search`` records exactly its two all-gathers, of
  B·k·(4 + 4) operand bytes (f32 distances and int32 ids);
* ``report.fmt_table`` has one row per written cell;
* the kernels are custom ops: fake tensors get their shapes and FLOPs and
  never reach a launch;
* ``--all`` runs every cell the reference lists and names the failures.
"""
import json

import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate  # noqa: E402

from repro_torch.configs.archs import ARCHS, smoke  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch import report  # noqa: E402
from repro_torch.launch import roofline as rf  # noqa: E402

ARCH_NAMES = ["gemma-2b", "dbrx-132b", "mamba2-1.3b", "llama-3.2-vision-11b"]
SHAPES = {"train": ShapeConfig("train_64", seq_len=64, global_batch=16,
                               kind="train"),
          "prefill": ShapeConfig("prefill_64", seq_len=64, global_batch=16,
                                 kind="prefill"),
          "decode": ShapeConfig("decode_64", seq_len=64, global_batch=16,
                                kind="decode")}
CELLS = [(a, k) for a in ARCH_NAMES for k in SHAPES]


@pytest.fixture(scope="module")
def mesh():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    dr.fake_world(16)
    try:
        yield init_device_mesh("cpu", (4, 4),
                               mesh_dim_names=("data", "model"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cells(mesh, tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    recs = {(a, k): dr.run_cell(a, SHAPES[k], False, str(out),
                                verbose=False, device="cpu", mesh=mesh,
                                cfg=smoke(ARCHS[a]))
            for a, k in CELLS}
    return recs, out


@pytest.mark.parametrize("arch,kind", CELLS)
def test_cell_runs_sharded(cells, arch, kind):
    r = cells[0][(arch, kind)]
    assert r["status"] == "ok"
    assert r["chips"] == 16 and r["mesh"] == "4x4"
    assert r["memory"]["peak_size_in_bytes"] > \
        r["memory"]["argument_size_in_bytes"] > 0
    assert set(r["roofline"]) >= {"compute_s", "memory_s", "collective_s",
                                  "bottleneck", "roofline_mfu"}


@pytest.mark.parametrize("arch,kind", CELLS)
def test_flop_count_within_the_reference_band(cells, arch, kind):
    r = cells[0][(arch, kind)]
    cfg, shape = smoke(ARCHS[arch]), SHAPES[kind]
    got = r["roofline"]["raw_cost_analysis"]["flop_counter_per_device"] * 16
    lo, hi = rf.model_flops_for(cfg, shape), 3 * rf.analytic_flops(cfg, shape)
    print(f"{arch} {kind}: counted / analytic = "
          f"{got / rf.analytic_flops(cfg, shape):.3f}")
    assert lo <= got <= hi, (lo, got, hi)


@pytest.mark.parametrize("arch,kind", CELLS)
def test_sharded_cell_records_collectives(cells, arch, kind):
    r = cells[0][(arch, kind)]
    counts = r["collective_counts"]
    assert counts.get("all-gather", 0) > 0       # FSDP gathers
    assert counts.get("all-reduce", 0) > 0       # the model axis' joins
    if kind == "train":
        assert counts.get("reduce-scatter", 0) > 0   # gradients
    links = r["roofline"]["coll_link_bytes"]
    assert links["nvlink"] > 0 and links["network"] > 0


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_argument_bytes_per_rank(mesh, arch):
    """Rank 0 holds at most a quarter of the one-rank arguments plus the
    leaves every rank holds whole."""
    with dr.FakeTensorMode(allow_non_fake_inputs=True):
        _, args, _, _ = dr.build_step(arch, SHAPES["train"], mesh, "cpu",
                                      smoke(ARCHS[arch]))
    total = repl = 0
    for t in torch.utils._pytree.tree_leaves(args):
        n = t.numel() * t.element_size()
        total += n
        if not isinstance(t, DTensor) or all(
                isinstance(p, Replicate) for p in t.placements):
            repl += n
    got = dr.local_bytes(args)
    assert got <= total / 4 + repl, (got, total, repl)
    assert got < total


def test_distributed_search_records_two_all_gathers(mesh):
    from repro_torch.core.distributed import dryrun_distributed_search
    B, k = 4, 3
    r = dryrun_distributed_search(mesh, n_lists=1024, max_len=8, dim=16,
                                  batch=B, nprobe_local=2, k=k,
                                  device="cpu")
    assert r["status"] == "ok" and r["chips"] == 16
    assert r["collective_counts"] == {"all-gather": 2}
    assert r["collective_bytes"] == {"all-gather": B * k * (4 + 4)}
    # the probe (the l2_distance op, by its formula) and the scan
    assert r["cost"]["flops_per_device"] >= 2 * B * (1024 // 16) * 16


def test_report_has_a_row_per_cell(cells):
    _, out = cells
    table = report.fmt_table(report.load_cells(str(out)), mesh="4x4")
    rows = table.splitlines()[2:]
    assert len(rows) == len(CELLS)
    assert {tuple(c.strip() for c in row.split("|")[1:3]) for row in rows} \
        == {(a, SHAPES[k].name) for a, k in CELLS}
    for path in out.glob("*.json"):
        assert json.loads(path.read_text())["status"] == "ok"


def test_kernels_never_launch_on_fake_tensors(monkeypatch):
    """The three kernels are custom ops: under ``FakeTensorMode`` they give
    their output shapes, dtypes and FLOPs and nothing runs."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels import ops, ref

    def boom(*a, **kw):
        raise AssertionError("a fake tensor reached a kernel")
    for mod, name in ((ops._distance, "l2_distance"),
                      (ops._fused_topk, "l2_topk"),
                      (ops._pq_adc, "adc_lookup"),
                      (ref, "l2_distance_ref"), (ref, "l2_topk_ref"),
                      (ref, "adc_lookup_ref")):
        monkeypatch.setattr(mod, name, boom)
    with dr.FakeTensorMode(), FlopCounterMode(display=False) as fc:
        q, x = torch.empty(32, 24), torch.empty(100, 24)
        d = ops.l2_distance(q, x)
        v, i = ops.l2_topk(q, x, 5)
        a = ops.adc_lookup(torch.empty(70, 8, dtype=torch.uint8),
                           torch.empty(8, 256))
    assert (d.shape, d.dtype) == ((32, 100), torch.float32)
    assert (v.shape, v.dtype, i.dtype) == ((32, 5), torch.float32,
                                           torch.int32)
    assert (a.shape, a.dtype) == ((70,), torch.float32)
    assert fc.get_total_flops() == 2 * (2 * 32 * 100 * 24) + 70 * 8


def test_vector_search_cli_and_the_device_check(tmp_path):
    """Last: ``main`` makes (and ends) its own fake world of 256 ranks."""
    dr.main(["--vector-search", "--device", "cpu", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "vector-search_32x8.json").read_text())
    assert rec["chips"] == 256 and rec["mesh"] == "32x8"
    assert rec["collective_counts"] == {"all-gather": 2}
    assert rec["collective_bytes"] == {"all-gather": 256 * 10 * 8}
    if not torch.backends.cuda.is_built():
        with pytest.raises(SystemExit, match="--device cpu"):
            dr.main(["--vector-search", "--out", str(tmp_path)])


def test_abstract_params_draw_nothing():
    """``LM.abstract`` and ``abstract_params`` give every parameter's shape
    and dtype on ``meta`` (no storage, no host draw): here gemma-2b at its
    full 2.5 B parameters."""
    from repro_torch.models.model import LM
    cfg = ARCHS["gemma-2b"]
    spec = LM.abstract(cfg).abstract_params()
    assert all(t.is_meta and t.dtype == torch.float32 for t in spec.values())
    assert sum(t.numel() for t in spec.values()) == 2_506_172_416
    small = LM(smoke(cfg), seed=0, device="cpu")
    assert {n: tuple(t.shape) for n, t in
            LM.abstract(smoke(cfg)).abstract_params().items()} == \
        {n: tuple(p.shape) for n, p in small.named_parameters()}


def test_all_runs_every_cell_and_names_the_failures(tmp_path, monkeypatch,
                                                    capsys):
    """``--all --both-meshes``: every (arch x shape x mesh) cell the
    reference lists, in order and in this process, a SKIP line for each
    full-attention ``long_500k``, then the search cells; a failing cell is
    named under ``# FAILURES`` and the exit code is 1.  (The cells are
    stand-ins here: ``run_cell`` itself is the tests above.)"""
    from repro_torch.configs.shapes import shapes_for
    ran, searched = [], []
    bad = ("gemma-2b", "train_4k", True)

    def cell(arch, shape_name, mp, out_dir, verbose=True, device="cuda"):
        assert (out_dir, verbose, device) == (str(tmp_path), False, "cpu")
        ran.append((arch, shape_name, mp))
        if (arch, shape_name, mp) == bad:
            raise RuntimeError("stand-in failure")
        return {"trace_s": 1.0, "memory": {"peak_size_in_bytes": 2 ** 30},
                "roofline": {"bottleneck": "compute", "roofline_mfu": 0.5}}
    monkeypatch.setattr(dr, "run_cell", cell)
    monkeypatch.setattr(dr, "run_vector_search_cell",
                        lambda mp, out_dir, device: searched.append(mp))
    with pytest.raises(SystemExit) as exit_:
        dr.main(["--all", "--both-meshes", "--device", "cpu", "--out",
                 str(tmp_path)])
    assert exit_.value.code == 1
    listed = [(a, name, s) for a, cfg in ARCHS.items()
              for name, s in shapes_for(cfg).items()]
    assert ran == [(a, name, mp) for a, name, s in listed if s is not None
                   for mp in (False, True)]
    assert (len(ran), searched) == (64, [False, True])
    out = capsys.readouterr().out
    assert out.count(": SKIP(full attention)") == 16
    assert out.count(": OK trace=1.0s peak=1.0GiB/rank bottleneck=compute "
                     "mfu=0.500") == 63
    assert "# gemma-2b x train_4k x 2x32x8: FAIL stand-in failure" in out
    assert out.splitlines()[-1] == f"# FAILURES: [{bad!r}]"
