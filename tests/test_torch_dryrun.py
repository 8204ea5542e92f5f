"""The port's dry-run (`repro_torch.launch.{costing,steps,dryrun_lib,dryrun,
dryrun_all}`) held against the JAX package where the reference can still
give an answer on this JAX: its analytic half (`model_param_counts`,
`attention_model_flops`, `model_flops`; relative 1e-12 on all 32 cells of
`ARCHS x cells_for`), `cells_for` and `LONG_CONTEXT_OK`, and rope at
positions near 2^19 (1e-6 absolute on unit-scale inputs).  Its compiled
half fails here (`tests/test_dryrun.py`, the reference's standing red
test), so the port's counter is held to itself: the same FLOPs and bytes
on meta as on real CPU tensors, at `--smoke` for each family.  The serve
steps are the models' own `prefill` / `decode_step` (bitwise on the
CPU), `run_cell` writes `status: ok` records, the reckoning of a long
prefill is the count at the length it reckons, and `--mesh single|multi`
refuses, naming ROADMAP item 17 (the dry-run of the sharded steps on a
fake process group; the test keeps its name from when the refusal named
item 13).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.configs import get_config as jget_config
from repro.launch import costing as JC
from repro.models import layers as JL
from repro_torch.configs import (ARCHS, LONG_CONTEXT_OK, SHAPES, ShapeSuite,
                                 cells_for, get_config, smoke_config)
from repro_torch.launch import costing as C
from repro_torch.launch import dryrun, dryrun_all
from repro_torch.launch import dryrun_lib as D
from repro_torch.launch import steps as S
from repro_torch.models import get_model
from repro_torch.models.layers import apply_rope
from repro_torch.models.module import materialize
from repro_torch.tree import tree_leaves

CELLS = [(a, c) for a in ARCHS for c in cells_for(a)]
# one arch of each family and form: dense local/global, MoE, VLM, RWKV6,
# the RG-LRU LM, the encoder-decoder
FAMILIES = ["gemma2-2b", "olmoe-1b-7b", "internvl2-2b", "rwkv6-3b",
            "recurrentgemma-9b", "whisper-large-v3"]


def _rel_equal(got, want, what):
    assert abs(got - want) <= 1e-12 * max(abs(want), 1.0), (what, got, want)


def test_cells_and_long_context_archs_equal_the_reference():
    assert LONG_CONTEXT_OK == JB.LONG_CONTEXT_OK
    assert len(CELLS) == 32
    for arch in ARCHS:
        assert cells_for(arch) == JB.cells_for(arch), arch
    assert cells_for("not-an-arch") == JB.cells_for("not-an-arch")


@pytest.mark.parametrize("arch,cell", CELLS)
def test_analytic_costs_equal_the_reference(arch, cell):
    cfg, jcfg = get_config(arch), jget_config(arch)
    shape, jshape = SHAPES[cell], JB.SHAPES[cell]
    got, want = C.model_param_counts(cfg), JC.model_param_counts(jcfg)
    assert got.keys() == want.keys()
    for k in want:
        _rel_equal(got[k], want[k], f"{arch} {cell} params {k}")
    _rel_equal(C.attention_model_flops(cfg, shape),
               JC.attention_model_flops(jcfg, jshape), f"{arch} {cell} attn")
    _rel_equal(C.model_flops(cfg, shape), JC.model_flops(jcfg, jshape),
               f"{arch} {cell} model_flops")


def test_rope_near_two_to_the_19_matches_the_reference():
    """Positions 524,200..524,287 (a long_500k decode's last ones) in f32:
    the angle is f32(pos) * f32(freq) in both packages, and both take its
    cos and sin to the f32 rounding."""
    rng = np.random.default_rng(0)
    pos = np.arange(524_200, 524_288, dtype=np.int32)[None]       # [1, 88]
    for theta in (10_000.0, 1_000_000.0):
        x = rng.standard_normal((1, pos.shape[1], 4, 256)).astype(np.float32)
        got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
        want = np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
        assert np.abs(got.numpy() - want).max() <= 1e-6


# ---------------------------------------------------------------------------
# The counter and the steps at --smoke, meta against real CPU tensors
# ---------------------------------------------------------------------------

def _real_args(cfg, kind, B, T, seed=0):
    """Real CPU arguments of the `kind` step: drawn parameters, an optimizer
    state, and a batch (or decode inputs and a zero cache) from a seed."""
    rng = np.random.default_rng(seed)
    api = get_model(cfg)
    params = materialize(api.specs(cfg), torch.Generator().manual_seed(seed))
    toks = lambda *s: torch.from_numpy(
        rng.integers(0, cfg.vocab_size, s).astype(np.int32))
    batch = {"tokens": toks(B, T), "labels": toks(B, T)}
    if cfg.n_patches > 0:
        batch["patch_embeds"] = torch.from_numpy(
            rng.standard_normal((B, cfg.n_patches, 4096))).to(torch.bfloat16)
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(
            rng.standard_normal((B, cfg.enc_seq, cfg.d_model))).to(torch.bfloat16)
    if kind == "train":
        return (params, S.default_optimizer(cfg).init(params), batch, 0)
    if kind == "prefill":
        batch.pop("labels")
        return (params, batch)
    pos = torch.full((B,), T // 2, dtype=torch.int32)
    return (params, toks(B, 1), api.init_cache(cfg, B, T, "cpu"), pos)


def _built(cfg, kind, B, T, device):
    shape = ShapeSuite("smoke", T, B, kind)
    return D.build_step(cfg, shape, device)


@pytest.mark.parametrize("arch", FAMILIES)
def test_count_on_meta_equals_count_on_cpu_tensors(arch):
    cfg = smoke_config(get_config(arch))
    B, T = 2, 16
    for kind in ("train", "prefill", "decode"):
        meta = _built(cfg, kind, B, T, "meta")
        cpu = _built(cfg, kind, B, T, "cpu")
        args = _real_args(cfg, kind, B, T)
        on_meta = C.count_step(meta.fn, *meta.args_abstract,
                               tagged=D._tags(kind, meta.args_abstract))
        on_cpu = C.count_step(cpu.fn, *args, tagged=D._tags(kind, args))
        assert on_meta["flops"] > 0, (arch, kind)
        for key in ("flops", "bytes"):
            assert on_meta[key] == on_cpu[key], (arch, kind, key)
        assert ([(p["name"], p["flops"], p["bytes"]) for p in on_meta["parts"]]
                == [(p["name"], p["flops"], p["bytes"]) for p in on_cpu["parts"]])
        assert sum(p["flops"] for p in on_meta["parts"]) == on_meta["flops"]
        # the stand-ins have the real arguments' shapes and dtypes
        leaves = lambda t: [(tuple(x.shape), x.dtype) for x in
                            tree_leaves(list(t)) if isinstance(x, torch.Tensor)]
        assert leaves(meta.args_abstract) == leaves(args), (arch, kind)


def test_parts_name_each_layer_and_sum_to_the_total():
    cfg = smoke_config(get_config("gemma2-2b")).replace(scan_layers=True)
    built = _built(cfg, "prefill", 2, 16, "meta")
    res = C.count_step(built.fn, *built.args_abstract,
                       tagged=C.part_tags(built.args_abstract[0]))
    names = [p["name"] for p in res["parts"]]
    assert names == ["embedding", "unit 0", "unit 1", "head"], names
    assert sum(p["flops"] for p in res["parts"]) == res["flops"]
    assert sum(p["bytes"] for p in res["parts"]) == res["bytes"]
    # the two units are the same work
    assert res["parts"][1]["flops"] == res["parts"][2]["flops"] > 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_steps_are_the_models_own_prefill_and_decode(arch):
    cfg = smoke_config(get_config(arch))
    api = get_model(cfg)
    B, T = 2, 16
    params, batch = _real_args(cfg, "prefill", B, T, seed=1)
    logits, cache = _built(cfg, "prefill", B, T, "cpu").fn(params, batch)
    extra = {"decoder": (batch.get("patch_embeds"),),
             "encdec": (batch.get("frames"),)}.get(cfg.family, ())
    kw = {} if cfg.family == "rwkv6" else {"max_seq": T}
    want_l, want_c = api.prefill(cfg, params, batch["tokens"], *extra, **kw)
    assert torch.equal(logits, want_l)
    for a, b in zip(tree_leaves(cache), tree_leaves(want_c)):
        assert torch.equal(a, b)
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    pos = torch.full((B,), T - 1, dtype=torch.int32)
    got = _built(cfg, "decode", B, T, "cpu").fn(params, tok, cache, pos)
    want = api.decode_step(cfg.replace(remat="none"), params, tok, want_c, pos)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)


def test_train_step_with_a_shape_gives_its_abstract_arguments():
    cfg = smoke_config(get_config("rwkv6-3b"))
    step = S.make_train_step(cfg)
    assert callable(step)
    built = S.make_train_step(cfg, shape=ShapeSuite("t", 16, 2, "train"))
    params, opt_state, batch, step0 = built.args_abstract
    assert built.donate == (0, 1) and step0 == 0
    assert all(t.device.type == "meta" for t in tree_leaves(
        [params, opt_state, batch]))
    out = built.fn(*built.args_abstract)
    assert out[0] is params and out[2]["loss"].shape == ()


# ---------------------------------------------------------------------------
# run_cell, the long prefill's reckoning, the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_run_cell_at_smoke_is_ok(arch, tmp_path):
    rec = D.run_cell(arch, "decode_32k", str(tmp_path), smoke=True)
    assert rec["status"] == "ok", rec.get("traceback")
    on_disk = json.loads((tmp_path / f"{arch}_decode_32k_card.json").read_text())
    assert on_disk["status"] == "ok" and on_disk["smoke"] is True


FULL_CELLS = [(a, c) for a, c in CELLS if c in ("decode_32k", "long_500k")]


@pytest.mark.parametrize("arch,cell", FULL_CELLS)
def test_run_cell_full_size_decode_cells_are_ok(arch, cell, tmp_path):
    rec = D.run_cell(arch, cell, str(tmp_path), tag="t")
    assert rec["status"] == "ok", rec.get("traceback")
    assert (tmp_path / f"{arch}_{cell}_card_t.json").exists()
    assert rec["mesh"] == "card" and rec["mesh_shape"] == {"card": 1}
    assert rec["cost_analysis"]["flops"] > 0 and rec["cost_analysis"]["bytes"] > 0
    mem = rec["memory"]
    params = C.model_param_counts(get_config(arch))["total"]
    specs = tree_leaves(get_model(get_config(arch)).specs(get_config(arch)))
    assert mem["argument_bytes"]["params"] == sum(
        s.size * s.dtype.itemsize for s in specs)
    assert mem["peak_bytes"] >= mem["argument_bytes"]["total"]
    # the two long-context archs' states fit one card; the others' caches
    # at 128 x 32,768 do not
    assert mem["fits_one_card"] is (arch in LONG_CONTEXT_OK)
    r = rec["roofline"]
    assert r["n_chips"] == 1 and r["params"]["total"] == params
    assert r["model_flops_global"] == C.model_flops(get_config(arch), SHAPES[cell])
    assert 0.5 < r["useful_flops_ratio"] < 1.1


@pytest.mark.parametrize("arch", ["rwkv6-3b", "recurrentgemma-9b"])
def test_reckoned_long_prefill_equals_the_count_at_its_length(arch):
    """The reckoning's lines (FLOPs at full depth, the peak at a cut depth
    plus the cut layers' exact bytes) at a length past the points equal
    a direct count there."""
    cfg = smoke_config(get_config(arch)).replace(n_layers=3 if arch ==
                                                 "recurrentgemma-9b" else 4)
    T, max_seq = 512, 544
    r = D.reckon_prefill(cfg, 1, T, max_seq, (64, 128), (128, 256),
                         peak_layers=3 if arch == "recurrentgemma-9b" else 2)
    built = S.make_prefill_step(cfg, ShapeSuite("p", max_seq, 1, "prefill"))
    args = (built.args_abstract[0],
            {"tokens": torch.empty((1, T), dtype=torch.int32, device="meta")})
    direct = C.count_step(built.fn, *args, peak=True, track=list(args))
    assert r["flops"] == direct["flops"]
    assert r["peak_bytes"] == direct["peak_bytes"]


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_the_reference_meshes_refuse_naming_item_13(mesh, tmp_path, capsys):
    code = dryrun.main(["--arch", "rwkv6-3b", "--shape", "long_500k",
                        "--mesh", mesh, "--out", str(tmp_path)])
    err = capsys.readouterr().err
    assert code != 0 and "item 17" in err and "fake process group" in err
    assert not list(tmp_path.iterdir())
    code = dryrun_all.main(["--mesh", mesh, "--out", str(tmp_path)])
    assert code != 0 and "item 17" in capsys.readouterr().err


def test_dryrun_cli_writes_the_record(tmp_path):
    code = dryrun.main(["--arch", "rwkv6-3b", "--shape", "long_500k",
                        "--out", str(tmp_path), "--skip-parts", "--tag", "x",
                        "--set", "n_layers=2"])
    rec = json.loads((tmp_path / "rwkv6-3b_long_500k_card_x.json").read_text())
    assert code == 0 and rec["status"] == "ok" and "parts" not in rec
    assert rec["overrides"] == {"n_layers": 2}
