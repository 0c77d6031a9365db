"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's (``repro.launch.roofline``), mirroring ``tests/test_roofline.py``.

* The analytic model (``analytic_flops``, ``analytic_bytes``,
  ``model_flops_for``) is a copy: float ``==`` with the reference for the
  ten archs x four shapes, at ``TRAIN_FLOP_FACTOR`` 4 and 3.
* The HLO-text parsing has no counterpart: collectives are read from a
  ``torch.profiler`` chrome trace.  A one-rank matmul has none; 12
  ``all_reduce``s on a one-rank gloo group count 12 with 12 calls' bytes
  (the counterpart of the trip-count walk: eager runs record every
  iteration); a literal trace with nested duplicates and ``wait_tensor``
  gives its hand-counted bytes; the dtype table; the link a group's size
  and nodes choose.  The dry-run records each collective as it is called,
  and those records are the trace's.
"""
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro.configs.archs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs.shapes import SHAPES as REF_SHAPES  # noqa: E402
from repro.launch import roofline as ref_rf  # noqa: E402
from repro_torch.configs.archs import ARCHS  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.launch import roofline as rf  # noqa: E402


@pytest.mark.parametrize("factor", [4.0, 3.0])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_analytic_model_equals_the_reference(arch, factor, monkeypatch):
    monkeypatch.setattr(rf, "TRAIN_FLOP_FACTOR", factor)
    monkeypatch.setattr(ref_rf, "TRAIN_FLOP_FACTOR", factor)
    for name, shape in SHAPES.items():
        cfg, rcfg, rshape = ARCHS[arch], REF_ARCHS[arch], REF_SHAPES[name]
        assert rf.analytic_flops(cfg, shape) == \
            ref_rf.analytic_flops(rcfg, rshape), name
        for chips in (256, 512):
            assert rf.analytic_bytes(cfg, shape, chips) == \
                ref_rf.analytic_bytes(rcfg, rshape, chips), (name, chips)
        assert rf.model_flops_for(cfg, shape) == \
            ref_rf.model_flops_for(rcfg, rshape), name


def _profile(fn):
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU], record_shapes=True)
    with prof, rf.annotate_groups():
        fn()
    return _chrome(prof)


def _chrome(prof):
    import json
    import tempfile
    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        prof.export_chrome_trace(f.name)
        return json.load(open(f.name))


@pytest.fixture
def one_rank_group():
    created = not dist.is_initialized()
    if created:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    yield dist.new_group([0], backend="gloo")
    if created:
        dist.destroy_process_group()


def test_collective_parse_simple():
    # one rank, no collective
    x = torch.ones(64, 64)
    trace = _profile(lambda: x @ x.T)
    assert rf.collective_bytes(trace) == {}
    assert rf.count_collectives(trace) == {}


def test_every_iteration_is_recorded(one_rank_group):
    """The counterpart of the reference's trip-count test: a loop of 12
    collectives is 12 records, eager execution records each."""
    x = torch.ones(32, 32)

    def loop():
        for _ in range(12):
            dist.all_reduce(x, group=one_rank_group)
    trace = _profile(loop)
    assert rf.count_collectives(trace) == {"all-reduce": 12}
    assert rf.collective_bytes(trace) == {"all-reduce": 12 * 32 * 32 * 4}
    recs = rf.collective_records(trace)
    assert {(r["group"], r["nodes"]) for r in recs} == {(1, 1)}


def test_shape_bytes():
    assert rf._shape_bytes("float", [4, 8]) == 128
    assert rf._shape_bytes("c10::BFloat16", [10]) == 20
    assert rf._shape_bytes("signed char", []) == 1
    assert rf._shape_bytes("long int", [3]) == 24


def _ev(name, ts, dur, dims=None, types=None, conc=None, tid=1):
    args = {}
    if dims is not None:
        args = {"Input Dims": dims, "Input type": types,
                "Concrete Inputs": conc or [""] * len(dims)}
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "pid": 1,
            "tid": tid, "args": args}


def test_trace_records_nested_duplicates_once():
    """A literal trace: an all-gather recorded by two nested layers, its
    wait, an all-reduce inside a group tag, a reduce-scatter, and a
    backend's own event on another thread."""
    ag = ([[64, 128], [], []], ["float", "Scalar", ""], ["", "8", ""])
    trace = {"traceEvents": [
        _ev("_c10d_functional::all_gather_into_tensor", 0, 10, *ag),
        _ev("_c10d_functional::all_gather_into_tensor", 1, 8, *ag),
        _ev("_c10d_functional::wait_tensor", 12, 2, [[512, 128]],
            ["float"]),
        _ev("c10d_group size=32 nodes=4", 20, 10),
        _ev("_c10d_functional::all_reduce", 21, 8, [[8, 4], [], []],
            ["c10::BFloat16", "", ""]),
        _ev("_c10d_functional::reduce_scatter_tensor", 40, 5,
            [[16], [], [], []], ["long int", "", "Scalar", ""],
            ["", "", "4", ""]),
        _ev("gloo:all_reduce", 22, 3, [[8, 4]], ["c10::BFloat16"], tid=2),
    ]}
    assert rf.count_collectives(trace) == {
        "all-gather": 1, "all-reduce": 1, "reduce-scatter": 1}
    assert rf.collective_bytes(trace) == {
        "all-gather": 64 * 128 * 4, "all-reduce": 8 * 4 * 2,
        "reduce-scatter": 16 * 8}
    assert rf.link_bytes(trace) == {"nvlink": 64 * 128 * 4 + 16 * 8,
                                    "network": 8 * 4 * 2}


def test_operand_of_an_output_first_op():
    """``c10d::_allgather_base_`` and ``_reduce_scatter_base_`` take their
    output first: the operand counted is the input (the second)."""
    trace = {"traceEvents": [
        _ev("c10d::_allgather_base_", 0, 5, [[4, 8], [1, 8], [], [], []],
            ["float", "float", "", "Scalar", "Scalar"]),
        _ev("c10d::_reduce_scatter_base_", 10, 5, [[2], [8], [], []],
            ["long int", "long int", "", ""]),
    ]}
    assert rf.collective_bytes(trace) == {"all-gather": 8 * 4,
                                          "reduce-scatter": 8 * 8}


def test_call_records_are_the_trace_records(one_rank_group):
    """What ``dryrun.Watch`` records as each collective is called
    (``call_record``) is what the profiler's trace of the same calls gives
    (``collective_records``): kinds, bytes, group and nodes."""
    from repro_torch.launch.dryrun import Watch
    x = torch.ones(16, 8)
    y = torch.ones(5, dtype=torch.bfloat16)
    name = one_rank_group.group_name

    def calls():
        for _ in range(3):
            dist.all_reduce(x, group=one_rank_group)
        g = torch.ops._c10d_functional.all_gather_into_tensor(y, 1, name)
        torch.ops._c10d_functional.wait_tensor(g)
        r = torch.ops._c10d_functional.all_reduce(x, "sum", name)
        torch.ops._c10d_functional.wait_tensor(r)
    watch = Watch()
    with watch:
        calls()
    traced = rf.collective_records(_profile(calls))
    assert watch.records == traced
    assert rf.count_collectives(watch.records) == {"all-reduce": 4,
                                                   "all-gather": 1}
    assert rf.collective_bytes(watch.records) == {
        "all-reduce": 4 * 16 * 8 * 4, "all-gather": 5 * 2}


def test_analytic_flops_matches_6nd_for_dense():
    """Analytic total must be close to 6·N·D x (waste >= 1) for a dense
    train cell."""
    cfg = ARCHS["internlm2-20b"]
    shape = SHAPES["train_4k"]
    got = rf.analytic_flops(cfg, shape)
    model = rf.model_flops_for(cfg, shape)
    assert model < got < 3.0 * model


def test_analytic_flops_moe_uses_active():
    cfg = ARCHS["dbrx-132b"]
    shape = SHAPES["train_4k"]
    got = rf.analytic_flops(cfg, shape)
    dense_equiv = 6.0 * (cfg.n_params() - cfg.vocab * cfg.d_model) \
        * shape.tokens
    assert got < 0.7 * dense_equiv


def test_decode_flops_tiny_vs_train():
    cfg = ARCHS["gemma-2b"]
    tr = rf.analytic_flops(cfg, SHAPES["train_4k"])
    de = rf.analytic_flops(cfg, SHAPES["decode_32k"])
    assert de < tr / 100


def test_roofline_terms_positive_and_bottleneck():
    # H100: 1e12 FLOP over 989e12 FLOP/s (1.0 ms) against 1e9 B over
    # 3.35e12 B/s (0.3 ms) and 1e8 NVLink bytes over 450e9 B/s (0.2 ms)
    r = rf.Roofline(chips=256, flops_per_device=1e12,
                    bytes_per_device=1e9, coll_bytes_per_device=1e8,
                    coll_breakdown={}, model_flops=2e14,
                    coll_link_bytes={"nvlink": 1e8, "network": 0})
    rep = r.report()
    assert rep["bottleneck"] == "compute"
    assert 0 < rep["roofline_mfu"] <= 1.0
    assert rep["collective_s"] == pytest.approx(1e8 / 450e9)
    # the same bytes across nodes: 1e8 / 50e9 = 2 ms, collective-bound
    r.coll_link_bytes = {}
    assert r.report()["bottleneck"] == "collective"
    assert r.collective_s == pytest.approx(1e8 / 50e9)


def test_model_flops_excludes_embedding_gather():
    cfg = ARCHS["gemma-2b"]        # 256k vocab, tied
    shape = SHAPES["train_4k"]
    n_mat = cfg.n_active_params() - cfg.vocab * cfg.d_model
    assert rf.model_flops_for(cfg, shape) == pytest.approx(
        6.0 * n_mat * shape.tokens)


@pytest.mark.parametrize("group,nodes,link", [
    (8, None, "nvlink"), (32, None, "network"), (None, None, "network"),
    (4, 1, "nvlink"), (4, 2, "network"), (256, 32, "network")])
def test_link_by_group(group, nodes, link):
    assert rf.link_of(group, nodes) == link


def test_annotated_groups_on_the_production_mesh():
    """On the (32, 8) mesh of a fake 256-rank world, an all-reduce over the
    model axis stays in a node (NVLink) and one over the data axis spans 32
    nodes (network)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from repro_torch.launch.dryrun import fake_world, production_mesh
    try:
        fake_world(256)
        mesh = production_mesh(False, "cpu")
        x = torch.ones(4, 8)

        def both():
            for pl in ((Replicate(), Partial()), (Partial(), Replicate())):
                DTensor.from_local(x, mesh, pl).redistribute(
                    mesh, (Replicate(), Replicate())).to_local()
        recs = rf.collective_records(_profile(both))
    finally:
        dist.destroy_process_group()
    assert [(r["kind"], r["group"], r["nodes"]) for r in recs] == [
        ("all-reduce", 8, 1), ("all-reduce", 32, 32)]
    assert [rf.link_of(r["group"], r["nodes"]) for r in recs] == [
        "nvlink", "network"]
