"""The port's logical-axis sharding rules (`models.module`, `sharding`,
`launch.steps`, `launch.mesh`, `core.scaled_rtrl.sharded_step_specs`)
against the reference's, without a process group: the rule functions take
the mesh's {name: size}, the reference's a `jax.sharding.AbstractMesh`, so
the production meshes (16, 16) and (2, 16, 16) are reasoned about without
256 ranks.  Every PartitionSpec is compared entry by entry with the
reference's, and the DTensor placements built from it are checked.  Also
the reference's own rule tests (tests/test_distribution.py), the int8
quantizer's round trip and K1's gate-segment table on a column shard."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding as JNS, PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro import sharding as JSH
from repro.configs import ARCHS, SHAPES, cells_for as jcells_for
from repro.configs import get_config as jget_config, smoke_config as jsmoke
from repro.core import scaled_rtrl as JSR
from repro.launch import steps as JST
from repro.models import get_model as jget_model
from repro.models import module as JM
from repro.optim import optimizers as JO
from repro_torch import sharding as SH
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import scaled_rtrl as SR, sparse_rtrl as SP
from repro_torch.kernels import compact_fused as CF
from repro_torch.launch import mesh as TM, steps as ST
from repro_torch.models import get_model
from repro_torch.models import module as MM
from repro_torch.optim import optimizers as O
from repro_torch.runtime.compression import _quant_int8
from repro_torch.tree import tree_flatten_with_path

MESHES = {(1, 1): ("data", "model"), (2, 2): ("data", "model"),
          (16, 16): ("data", "model"),
          (2, 16, 16): ("pod", "data", "model")}


def _meshes(shape):
    names = MESHES[shape]
    return AbstractMesh(shape, names), dict(zip(names, shape))


def _jspecs(tree):
    """[(path, entries)] of a reference tree of PartitionSpecs."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return [tuple(x) for _, x in leaves]


class _Leaf:
    """A PartitionSpec tuple as one tree leaf (the port's tree walk would
    otherwise descend into it)."""

    def __init__(self, spec):
        self.spec = spec


def _as_leaves(tree):
    if isinstance(tree, dict):
        return {k: _as_leaves(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_leaves(v) for v in tree]
    if isinstance(tree, tuple) and not all(
            e is None or isinstance(e, (str, tuple)) for e in tree):
        return [_as_leaves(v) for v in tree]
    return _Leaf(tree)


def _flat_specs(tree):
    return [leaf.spec for _, leaf in tree_flatten_with_path(
        _as_leaves(tree))]


@pytest.mark.parametrize("pure_dp", [False, True])
@pytest.mark.parametrize("shape", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_tree_pspecs_equal_the_reference(arch, shape, pure_dp):
    """Every parameter's PartitionSpec of every arch, in both rule modes,
    entry by entry the reference's; the placements shard each named mesh
    dim's tensor dim."""
    jmesh, tmesh = _meshes(shape)
    jcfg, cfg = jget_config(arch), get_config(arch)
    want = _jspecs(JM.tree_pspecs(jget_model(jcfg).specs(jcfg),
                                  JSH.make_rules(jcfg, jmesh, pure_dp=pure_dp),
                                  jmesh))
    specs = get_model(cfg).specs(cfg)
    got = _flat_specs(MM.tree_pspecs(specs, SH.make_rules(
        cfg, tmesh, pure_dp=pure_dp), tmesh))
    assert got == want
    names = tuple(tmesh)
    for spec in got:
        pl = MM.placements_for(spec, names)
        for d, entry in enumerate(spec):
            for a in (() if entry is None else
                      (entry,) if isinstance(entry, str) else entry):
                assert pl[names.index(a)] == Shard(d)
        used = {a for e in spec if e is not None
                for a in ((e,) if isinstance(e, str) else e)}
        assert all(pl[i] == Replicate() for i, a in enumerate(names)
                   if a not in used)


@pytest.mark.parametrize("shape", [(2, 2), (16, 16), (2, 16, 16)])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_pspecs_equal_the_reference(arch, shape):
    """cache_pspec of every cache leaf (B 128, S 2048) entry by entry the
    reference's, and the port's cache_shardings over its own cache tree
    names the same specs, but for the RG-LRU LM's remainder layers: those
    are a list beside the stacked units, which the reference reads as
    stacked too (ROADMAP Queue 3, fault 12); the port gives them their
    unstacked spec."""
    jmesh, tmesh = _meshes(shape)
    jcfg, cfg = jget_config(arch), get_config(arch)
    jcache = jax.eval_shape(lambda: jget_model(jcfg).init_cache(jcfg, 128,
                                                                2048))
    jsh = JSH.cache_shardings(jcache, jcfg, jmesh)
    want = [tuple(s.spec) for s in jax.tree.leaves(jsh)]
    rules = SH.make_rules(cfg, tmesh)
    leaves = jax.tree_util.tree_flatten_with_path(jcache)[0]
    got = [SH.cache_pspec(str(getattr(p[-1], "key", p[-1])), x.shape, rules,
                          tmesh, cfg.scan_layers) for p, x in leaves]
    assert got == want
    tcache = get_model(cfg).init_cache(cfg, 128, 2048, "meta")
    tsh = SH.cache_shardings(tcache, cfg, tmesh)
    tleaves = tree_flatten_with_path(tcache)
    by_shape = {}
    for (p, x), (_, s) in zip(tleaves, tree_flatten_with_path(
            _as_named(tsh))):
        by_shape.setdefault((str(p[-1]), tuple(x.shape)), s.spec)
    for (p, x), w in zip(leaves, want):
        name = str(getattr(p[-1], "key", p[-1]))
        key = (name, tuple(x.shape))
        if getattr(p[0], "key", None) == "rem":
            w = SH.cache_pspec(name, x.shape, rules, tmesh, False)
        if key in by_shape:
            assert by_shape[key] == w


def _as_named(tree):
    if isinstance(tree, dict):
        return {k: _as_named(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_as_named(v) for v in tree]
    return tree


@pytest.mark.parametrize("pure_dp", [False, True])
@pytest.mark.parametrize("shape", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_batch_shardings_equal_the_reference(arch, shape, pure_dp):
    """batch_shardings of every ShapeSuite cell of the arch."""
    jmesh, tmesh = _meshes(shape)
    jcfg, cfg = jget_config(arch), get_config(arch)
    for cell in jcells_for(arch):
        want = JST.batch_shardings(jcfg, SHAPES[cell], jmesh, pure_dp)
        got = ST.batch_shardings(cfg, SHAPES[cell], tmesh, pure_dp)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].spec == tuple(want[k].spec), (cell, k)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("shape", [(2, 2), (16, 16)])
def test_mirror_opt_shardings_equal_the_reference(opt, shape):
    """The optimizer state's shardings mirror the params' where the leaves
    match (adamw's moments), else replicate (adafactor's factors)."""
    jmesh, tmesh = _meshes(shape)
    jcfg = jsmoke(jget_config("qwen3-8b"))
    cfg = smoke_config(get_config("qwen3-8b"))
    jspecs = jget_model(jcfg).specs(jcfg)
    jp_abs = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype),
                          jspecs, is_leaf=lambda x: isinstance(x, JM.ParamSpec))
    jp_sh = JM.tree_shardings(jspecs, JSH.make_rules(jcfg, jmesh), jmesh)
    jopt = jax.eval_shape(JO.make_optimizer(opt, lr=1e-3).init, jp_abs)
    want = JST.mirror_opt_shardings(jopt, jp_abs, jp_sh, jmesh)
    tspecs = get_model(cfg).specs(cfg)
    tp_abs = MM.abstract(tspecs)
    tp_sh = MM.tree_shardings(tspecs, SH.make_rules(cfg, tmesh), tmesh)
    topt = O.make_optimizer(opt, lr=1e-3).init(tp_abs)
    got = ST.mirror_opt_shardings(topt, tp_abs, tp_sh, tmesh)
    assert sorted(got) == sorted(want)
    for k in want:
        wl = [tuple(s.spec) for s in jax.tree.leaves(want[k])]
        gl = [s.spec for _, s in tree_flatten_with_path(_as_named(got[k]))]
        assert gl == wl, k


def test_mirror_opt_shardings_small():
    """test_distribution.py:136 on a (1, 1) mesh."""
    mesh = {"data": 1, "model": 1}
    p_abs = {"w": torch.empty(8, 8, device="meta")}
    p_sh = {"w": MM.NamedSharding(mesh, ("data", "model"))}
    opt_abs = {"m": {"w": torch.empty(8, 8, device="meta")},
               "f": {"w": {"vr": torch.empty(8, device="meta")}}}
    sh = ST.mirror_opt_shardings(opt_abs, p_abs, p_sh, mesh)
    assert sh["m"]["w"].spec == ("data", "model")
    assert sh["f"]["w"]["vr"].spec == ()


def test_pspec_divisibility_fallback():
    """test_distribution.py:15: 8 heads on a 16-way axis are dropped."""
    rules = MM.ShardingRules({"heads": "model", "mlp": "model"})
    spec = MM.pspec_for(("heads", "mlp"), (8, 9216), rules,
                        {"data": 16, "model": 16})
    assert spec == (None, "model")
    assert spec == tuple(JM.pspec_for(
        ("heads", "mlp"), (8, 9216), JM.ShardingRules(
            {"heads": "model", "mlp": "model"}),
        AbstractMesh((16, 16), ("data", "model"))))


def test_pspec_axis_used_once():
    """test_distribution.py:27: a mesh axis shards one tensor dim only."""
    rules = MM.ShardingRules({"a": "model", "b": "model"})
    assert MM.pspec_for(("a", "b"), (32, 32), rules,
                        {"data": 16, "model": 16}) == ("model",)


def test_nested_axes_place_major_to_minor():
    """('pod', 'data') on one dim: both mesh dims shard it, in mesh order;
    an entry out of mesh order cannot be expressed and raises."""
    names = ("pod", "data", "model")
    assert MM.placements_for((("pod", "data"), None), names) == (
        Shard(0), Shard(0), Replicate())
    with pytest.raises(ValueError, match="mesh-dim order"):
        MM.placements_for((("data", "pod"),), names)
    # this rank's slice: pod major, data minor
    idx = SH.local_index((8, 3), (Shard(0), Shard(0), Replicate()),
                         (1, 0, 1), (2, 2, 2))
    assert idx == (slice(4, 6), slice(0, 3))
    with pytest.raises(ValueError, match="split evenly"):
        SH.local_index((5,), (Shard(0),), (0,), (2,))


@pytest.mark.parametrize("L", [1, 2])
@pytest.mark.parametrize("shape", [(1, 2), (16, 16), (2, 16, 16)])
def test_sharded_step_specs_equal_the_reference(L, shape):
    """sharded_step_specs returns the reference's specs, every layer's
    buffer sharded the same way, and placements (vals: batch over the
    batch axes, columns over 'model')."""
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    jmesh, tmesh = AbstractMesh(shape, names), dict(zip(names, shape))
    kw = dict(n=32, n_in=8, batch=4, n_layers=L)
    jst, jx = JSR.sharded_step_specs(JSR.ScaledRTRLConfig(**kw), jmesh)
    st, x = SR.sharded_step_specs(SR.ScaledRTRLConfig(**kw), tmesh)
    for k in ("a", "vals", "idx"):
        want = jax.tree.leaves(jst[k], is_leaf=lambda s: isinstance(s, JNS))
        got = st[k] if L > 1 else (st[k],)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.spec == tuple(w.spec)
    assert x.spec == tuple(jx.spec)
    vals = st["vals"][0] if L > 1 else st["vals"]
    ba = [i for i, a in enumerate(names) if a != "model"]
    assert all(vals.placements[i] == Shard(0) for i in ba)
    assert vals.placements[names.index("model")] == Shard(2)


def test_int8_quant_roundtrip_bounds():
    """test_distribution.py:83, and the codes and scale equal the
    reference's on the same input (round half to even)."""
    from repro.runtime.compression import _quant_int8 as jq
    x = np.random.default_rng(0).standard_normal(128).astype(np.float32)
    x[:4] = [0.5, 1.5, 2.5, -2.5]          # halves: ties to even
    x = x / np.abs(x).max() * 127.0 * 0.25
    q, s = _quant_int8(torch.from_numpy(x))
    err = (q.float() * s - torch.from_numpy(x)).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-6
    jqv, js = jq(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    assert float(s) == float(js)


def test_production_mesh_refuses_another_world_size():
    """make_production_mesh raises with the world size, as the reference's
    jax.make_mesh does on another device count; make_host_mesh needs a
    process group."""
    with pytest.raises(ValueError, match="needs 256 ranks; this process "
                       "group has 1"):
        TM.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs 512 ranks"):
        TM.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        TM.make_host_mesh(device="cpu")


@pytest.mark.parametrize("n_model", [2, 4, 16])
def test_k1_segments_on_a_column_shard(n_model):
    """K1's gate-segment table built from a shard of the compact columns
    (a GRU layout: u, r, z and theta runs) that starts inside a gate's
    run or holds none of a gate's columns: each shard's segments are the
    whole table's cut to its columns, shifted to its origin."""
    from repro_torch.core import cells as C
    cfg = C.EGRUConfig(n_hidden=24, n_in=8, n_out=2, kind="gru")
    lay = SP.flat_layout(cfg)
    masks = SP.make_masks(cfg, torch.Generator().manual_seed(0), 0.7,
                          device="cpu")
    cl = SP.col_layout(lay, masks, device="cpu")
    whole = CF.fused_segments(lay, cl)
    w = cl.Pc_pad // n_model
    cuts = set()
    for m in range(n_model):
        c0 = m * w
        sl = slice(c0, c0 + w)
        import dataclasses
        loc = dataclasses.replace(
            cl, Pc=int(cl.live[sl].sum()), Pc_pad=w,
            **{f: getattr(cl, f)[sl] for f in
               ("src", "layer", "gate", "q", "j", "live")})
        segs = CF.fused_segments(lay, loc)
        want = []
        for a, b, kind, ck, gk, q, j in whole:
            lo, hi = max(a, c0), min(b, c0 + w)
            if lo < hi:
                want.append((lo - c0, hi - c0, kind, ck, gk,
                             q[lo - a:hi - a], j[lo - a:hi - a]))
                cuts.add((a < c0 < b) or (a < c0 + w < b))
        assert [s[:5] for s in segs] == [s[:5] for s in want]
        for s, t in zip(segs, want):
            np.testing.assert_array_equal(s[5], t[5])
            np.testing.assert_array_equal(s[6], t[6])
        assert len(segs) <= len(whole)
    assert True in cuts          # some shard starts or ends inside a run
