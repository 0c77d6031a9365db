"""The port's placement rules (``launch/sharding.py``) against the
reference's, and its meshes (``launch/mesh.py``).

Nothing is allocated: the reference's parameters are ``jax.eval_shape`` of
``LM.init`` at the ten FULL-size configs, the port's an ``LM`` on the
``meta`` device.  Meshes are stubs (an object with ``axis_names`` and
``devices.shape`` for the reference, a dict of axis sizes for the port) of
shapes (1, 1), (16, 16) and (2, 16, 16), under both policies.  The
reference stacks the layers of its repeating unit along a leading axis
(``unit`` in the path); that axis's ``None`` falls away in the port, whose
layers are a list, so a stacked leaf's spec is compared without it.
Specs must be equal: the rules are integer arithmetic on shapes.  (The
reference's ``NamedSharding`` wrapper is stubbed, as its meshes are.)
"""
import dataclasses
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.archs import ARCHS as REF_ARCHS  # noqa: E402
from repro.launch import sharding as ref_sh  # noqa: E402
from repro.models.model import LM as RefLM  # noqa: E402
from repro.models.transformer import unit_structure  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402

MESHES = {"1x1": (("data", "model"), (1, 1)),
          "16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
POLICIES = ("tp_fsdp", "fsdp")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small eager steps: several contend
    with the other test workers' threads and run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_mesh(name):
    axes, shape = MESHES[name]
    return types.SimpleNamespace(axis_names=axes,
                                 devices=types.SimpleNamespace(shape=shape))


def _port_mesh(name):
    axes, shape = MESHES[name]
    return dict(zip(axes, shape))


@pytest.fixture(autouse=True)
def _stub_named_sharding(monkeypatch):
    """The reference's ``*_shardings`` wrap each spec in a NamedSharding of
    a real mesh; here they keep the spec."""
    monkeypatch.setattr(ref_sh, "NamedSharding",
                        lambda mesh, spec: types.SimpleNamespace(spec=spec))


@pytest.fixture
def policy(request):
    ref_sh.set_policy(request.param)
    sh.set_policy(request.param)
    yield request.param
    ref_sh.set_policy("tp_fsdp")
    sh.set_policy("tp_fsdp")


def _port_cfg(cfg):
    return ModelConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(cfg)})


_ABSTRACT = {}


def _models(arch):
    """(reference config, its abstract parameters, the port's meta LM)."""
    if arch not in _ABSTRACT:
        cfg = REF_ARCHS[arch]
        ref = RefLM(cfg)
        port = LM(_port_cfg(cfg), seed=None, device="meta")
        _ABSTRACT[arch] = (cfg, ref, ref.abstract_params(), port)
    return _ABSTRACT[arch]


def _ref_leaves(cfg, aparams):
    """``{port name: (reference path, leaf, stacked)}`` for every leaf."""
    unit, n_rep, _ = unit_structure(cfg)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(aparams)[0]:
        ps = ref_sh._path_str(path)
        parts = ps.split("/")
        if parts[0] == "blocks" and parts[1] == "unit":
            j, rest = int(parts[2]), ".".join(parts[3:])
            for r in range(n_rep):
                out[f"blocks.{r * len(unit) + j}.{rest}"] = (ps, leaf, True)
        elif parts[0] == "blocks":
            i = n_rep * len(unit) + int(parts[2])
            out[f"blocks.{i}.{'.'.join(parts[3:])}"] = (ps, leaf, False)
        else:
            out[".".join(parts)] = (ps, leaf, False)
    return out


@pytest.mark.parametrize("policy", POLICIES, indirect=True)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_param_pspec_matches_reference(arch, mesh, policy):
    cfg, _, aparams, port = _models(arch)
    ref_leaves = _ref_leaves(cfg, aparams)
    port_shapes = {n: tuple(p.shape) for n, p in port.named_parameters()}
    assert set(port_shapes) == set(ref_leaves)
    got = sh.params_shardings(_port_mesh(mesh), port.state_dict())
    rmesh = _ref_mesh(mesh)
    n_sharded = 0
    for name, (path, leaf, stacked) in ref_leaves.items():
        want = tuple(ref_sh.param_pspec(rmesh, path, leaf))
        shape = tuple(leaf.shape)
        if stacked:
            assert want[:1] in ((), (None,)), (path, want)
            want, shape = want[1:], shape[1:]
        assert port_shapes[name] == shape, name
        want = want + (None,) * (len(shape) - len(want))
        assert got[name].spec == want, (name, path, got[name].spec, want)
        n_sharded += any(s is not None for s in want)
        assert got[name].placements == sh.placements(_port_mesh(mesh), want)
    assert (n_sharded > 0) == (mesh != "1x1")


@pytest.mark.parametrize("policy", POLICIES, indirect=True)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_axes_and_batch_shardings_match_reference(mesh, policy):
    rmesh, pmesh = _ref_mesh(mesh), _port_mesh(mesh)
    for b in (1, 2, 8, 16, 32, 48, 256, 512, 1024, 4096):
        assert sh.batch_axes(pmesh, b) == ref_sh.batch_axes(rmesh, b), b
        sds = jax.ShapeDtypeStruct
        ref_batch = {"tokens": sds((b, 4096), np.int32),
                     "labels": sds((b, 4096), np.int32),
                     "image_embeds": sds((b, 1601, 4096), np.float32),
                     "pos": sds((), np.int32)}
        want = ref_sh.batch_shardings(rmesh, ref_batch)
        got = sh.batch_shardings(pmesh, {k: torch.empty(v.shape, device="meta")
                                         for k, v in ref_batch.items()})
        for k in ref_batch:
            assert got[k].spec == tuple(want[k].spec), (b, k)


def _layer_caches(cfg, caches):
    """The reference's caches per layer in the port's order, the unit's
    with their leading (layer) axis dropped."""
    unit, n_rep, _ = unit_structure(cfg)
    per_layer = [None] * cfg.n_layers
    for j, c in enumerate(caches["unit"]):
        for r in range(n_rep):
            per_layer[r * len(unit) + j] = jax.tree.map(
                lambda a: jax.ShapeDtypeStruct(a.shape[1:], a.dtype), c)
    for i, c in enumerate(caches["tail"]):
        per_layer[n_rep * len(unit) + i] = c
    return per_layer


@pytest.mark.parametrize("policy", POLICIES, indirect=True)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_cache_shardings_match_reference(arch, mesh, policy):
    """The reference's rule on each layer's cache (the shapes of its own
    ``init_caches``, checked) against the port's on its per-layer caches."""
    cfg, ref, _, port = _models(arch)
    rmesh, pmesh = _ref_mesh(mesh), _port_mesh(mesh)
    for batch, capacity in ((1, 4096), (32, 8192), (128, 2048)):
        ref_layers = _layer_caches(cfg, jax.eval_shape(
            lambda: ref.init_caches(batch, capacity)))
        port_caches = port.init_caches(batch, capacity)
        want = ref_sh.cache_shardings(rmesh, ref_layers, batch)
        got = sh.cache_shardings(pmesh, port_caches, batch)
        for i, (w, g, c) in enumerate(zip(want, got, port_caches)):
            if isinstance(c, dict):
                pairs = [(w[k], g[k], c[k], ref_layers[i][k]) for k in c]
            else:
                pairs = list(zip(w, g, c, ref_layers[i]))
            for wk, gk, ck, rk in pairs:
                assert tuple(ck.shape) == tuple(rk.shape), (i, ck.shape, rk.shape)
                assert gk.spec == tuple(wk.spec), (arch, i, gk.spec, wk.spec)


def test_opt_state_and_placements():
    pmesh = _port_mesh("2x16x16")
    psh = sh.params_shardings(pmesh, {"embed": torch.empty((256000, 2048),
                                                           device="meta"),
                                      "blocks.0.ffn.wi": torch.empty(
                                          (2048, 16384), device="meta")})
    assert psh["embed"].spec == ("model", "data")
    assert psh["embed"].placements == (sh.Replicate(), sh.Shard(1),
                                       sh.Shard(0))
    osh = sh.opt_state_shardings(pmesh, psh)
    assert osh["m"] is psh and osh["v"] is psh
    assert osh["step"].spec == () and all(
        p == sh.Replicate() for p in osh["step"].placements)
    # a dim over two axes is split by the first, then the second
    assert sh.placements(pmesh, (None, ("data", "model"))) == (
        sh.Replicate(), sh.Shard(1), sh.Shard(1))
    with pytest.raises(ValueError):
        sh.set_policy("zero")


def test_host_mesh_replicates_every_parameter():
    """On the 1x1 host mesh (a one-rank gloo group made for it) every
    placement is ``Replicate()``: the launcher keeps plain tensors."""
    import torch.distributed as dist

    from repro_torch.configs.archs import ARCHS, smoke
    from repro_torch.launch.mesh import make_host_mesh

    assert not dist.is_initialized()
    mesh = make_host_mesh("cpu")
    try:
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1) and mesh.size() == 1
        assert sh.axis_sizes(mesh) == {"data": 1, "model": 1}
        lm = LM(smoke(ARCHS["gemma-2b"]), seed=0, device="cpu")
        for s in sh.params_shardings(mesh, lm.state_dict()).values():
            assert all(p == sh.Replicate() for p in s.placements)
    finally:
        dist.destroy_process_group()


def test_production_mesh_over_a_one_rank_world():
    """Over a world of one rank the production mesh is 1 x 1 with the
    reference's axis names; two pods cannot be cut from it."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(device="cpu")
    try:
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
        with pytest.raises(ValueError, match="does not cover"):
            make_production_mesh(multi_pod=True, device="cpu")
    finally:
        dist.destroy_process_group()
