"""The port's ``sharding.py`` against the JAX package's, and its sharded
tensors on meshes of repeated CPU devices: the rules, specs and
sanitized specs equal the reference's for every arch, mesh and mode;
the dense family's state and cache specs equal the reference's leaf for
leaf; every coordinate holds only its slice; the collectives and their
autograd transposes; elastic restore across packages and layouts, bit
for bit.  Exact comparisons throughout (no tolerance: specs are data,
and a restore copies bytes)."""
from dataclasses import replace

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import checkpoint as rckpt  # noqa: E402
from repro import sharding as rshd  # noqa: E402
from repro.configs import ALL_ARCHS  # noqa: E402
from repro.configs import get_config as rget_config  # noqa: E402
from repro.configs import smoke_variant as rsmoke  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.train import step as rstep  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import sharding as shd  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.core.distributed import Mesh  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.common import ShardCtx  # noqa: E402
from repro_torch.train import loop  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

KEY = jax.random.PRNGKey(0)
MESHES = {"1x1": (1, 1), "2x2": (2, 2), "2x4": (2, 4), "1x4": (1, 4),
          "pod2x2x2": (2, 2, 2)}
DENSE = ["smollm-135m", "qwen3-4b", "llama3.2-3b", "yi-34b"]
MODES = {"train": {}, "serving": {"serving": True},
         "small_batch": {"small_batch": True},
         "serving_small_batch": {"serving": True, "small_batch": True}}


def port_mesh(shape):
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return Mesh(np.full(shape, "cpu", dtype=object), names)


class FakeMesh:
    """The reference's rules and sanitizer read only these two."""

    def __init__(self, shape):
        self.axis_names = (("pod", "data", "model") if len(shape) == 3
                           else ("data", "model"))
        self.shape = dict(zip(self.axis_names, shape))


def as_tuple(sp):
    return tuple(sp)


def _stub(shape):
    """A zero-byte stand-in with a shape that indexes like an array."""
    return np.broadcast_to(np.zeros((), np.int8), tuple(shape))


# -- rules, spec, sanitize_spec ------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_rules_and_specs_equal_reference(arch, mesh_name):
    """Every mode's rule table, the spec of every logical name and of
    the model's constraint tuples, and those specs sanitized against
    shapes that do and do not divide, equal the reference's."""
    shape = MESHES[mesh_name]
    cfg, rcfg = get_config(arch), rget_config(arch)
    pm, fm = port_mesh(shape), FakeMesh(shape)
    assert pm.shape == fm.shape
    assert shd.data_axes(pm) == rshd.data_axes(fm)
    combos = [(n,) for n in rshd.make_rules(fm, rcfg)] + [
        ("batch", "seq_sp", None), ("batch", None, "heads", None),
        ("fsdp", "heads", None), ("heads", None, "fsdp"), ("fsdp", "ffn"),
        ("ffn", "fsdp"), ("vocab", "fsdp"), ("fsdp", "vocab"),
        ("batch", None, "vocab"), ("experts", "fsdp", None),
        (None, "cache_batch", "cache_seq", "cache_heads", None), ()]
    shapes = [(48, 40, 36, 30, 64), (7, 9, 5, 3, 1), (16, 12, 8, 256, 8),
              (cfg.vocab_padded, cfg.d_model, cfg.num_heads,
               cfg.eff_num_kv_heads, cfg.head_dim)]
    for mode, kw in MODES.items():
        rules = shd.make_rules(pm, cfg, **kw)
        rrules = rshd.make_rules(fm, rcfg, **kw)
        assert rules == rrules, mode
        assert api.batch_specs(cfg, rules) == {
            k: as_tuple(v) for k, v in rapi.batch_specs(rcfg, rrules).items()}
        for names in combos:
            sp = shd.spec(rules, *names)
            assert sp == as_tuple(rshd.spec(rrules, *names)), (mode, names)
            for dims in shapes:
                dims = dims[:len(names)]
                assert shd.sanitize_spec(sp, dims, pm) == as_tuple(
                    rshd.sanitize_spec(P(*sp), dims, fm)), (mode, names,
                                                           dims)


def test_sanitize_matches_the_reference_system_cases():
    """``tests/test_system.py``'s ``test_sharding_sanitize`` cases."""

    class Fake:
        shape = {"data": 4, "model": 8}

    assert shd.sanitize_spec(("data", "model"), (8, 24), Fake()) == \
        ("data", "model")
    assert shd.sanitize_spec(("data", "model"), (6, 24), Fake()) == \
        (None, "model")
    assert shd.sanitize_spec((("data", "model"),), (32,), Fake()) == \
        (("data", "model"),)
    assert shd.sanitize_spec((("data", "model"),), (33,), Fake()) == (None,)
    # and the tree form over dicts of specs
    tree = {"a": ("data", None), "b": {"c": ("model",)}}
    got = shd.sanitize_spec_tree(tree, {"a": _stub((6, 2)),
                                        "b": {"c": _stub((16,))}}, Fake())
    assert got == {"a": (None, None), "b": {"c": ("model",)}}


# -- the dense family's state and cache specs ------------------------------------

def _ref_target(rcfg):
    return jax.eval_shape(lambda k: rstep.init_state(rcfg, k),
                          jax.ShapeDtypeStruct((2,), np.uint32))


def _spec_leaves(tree):
    """Path ``a/b/c`` -> spec tuple of a reference tree of
    ``PartitionSpec``s."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(p.key) for p in path): tuple(sp)
            for path, sp in leaves}


def _port_flat_shapes(rtarget_params):
    """The port's parameter names and shapes from the reference's stacked
    tree of shapes (a layer's shape drops the layer axis)."""
    flat = convert.lm_flat(jax.tree.map(lambda s: _stub(s.shape),
                                        rtarget_params))
    return {n: tuple(v.shape) for n, v in flat.items()}


@pytest.mark.parametrize("mesh_name", ["2x2", "2x4", "1x4", "pod2x2x2"])
@pytest.mark.parametrize("arch", DENSE)
def test_state_and_cache_specs_equal_reference(arch, mesh_name):
    """``train.step.state_specs`` and ``api.cache_specs``, sanitized, equal
    the reference's leaf for leaf (a layer's spec behind the reference's
    stacked ``None``), under the training and serving rules."""
    shape = MESHES[mesh_name]
    cfg, rcfg = get_config(arch), rget_config(arch)
    pm, fm = port_mesh(shape), FakeMesh(shape)
    target = _ref_target(rcfg)
    shapes = _port_flat_shapes(target["params"])
    for kw in ({}, {"serving": True}, {"small_batch": True}):
        rules, rrules = shd.make_rules(pm, cfg, **kw), rshd.make_rules(
            fm, rcfg, **kw)
        ours = tstep.state_specs(cfg, rules)
        theirs = rshd.sanitize_spec_tree(rstep.state_specs(rcfg, rrules),
                                         target, fm)
        assert ours["opt"]["step"] == as_tuple(theirs["opt"]["step"]) == ()
        assert sorted(ours["params"]) == sorted(shapes)
        for part in ("params", "mu", "nu"):
            got = ours["params"] if part == "params" else ours["opt"][part]
            want = theirs["params"] if part == "params" else \
                theirs["opt"][part]
            want = _spec_leaves(want)
            for name, sp in got.items():
                san = shd.sanitize_spec(sp, shapes[name], pm)
                key = name.split(".")
                if key[0] == "layers":
                    key, san = [key[0]] + key[2:], (None,) + san
                assert san == want["/".join(key)], (kw, part, name)
        B, S = 4, 64
        rcache = rapi.cache_specs(rcfg, rrules)
        rstruct = rapi.cache_struct(rcfg, B, S)
        want = _spec_leaves(rshd.sanitize_spec_tree(rcache, rstruct, fm))
        got = api.cache_specs(cfg, rules)
        kv_shape = (cfg.num_layers, B, S, cfg.eff_num_kv_heads, cfg.head_dim)
        assert got["len"] == want["len"] == ()
        for k in ("k", "v"):
            assert shd.sanitize_spec(got["kv"][k], kv_shape, pm) == \
                want[f"kv/{k}"], (kw, k)


def test_mesh_path_is_the_dense_family_only():
    """Kept under its first name (the mesh path ran the dense family
    only): every family's parameters now take their specs from the one
    table, olmoe's experts on the model axis with their ``d`` on the
    data axes, its router whole."""
    rules = shd.make_rules(port_mesh((2, 2)), get_config("olmoe-1b-7b"))
    specs = api.param_specs(get_config("olmoe-1b-7b"), rules)
    assert specs["layers.0.moe.wg"] == ("model", "data", None)
    assert specs["layers.0.moe.wd"] == ("model", None, "data")
    assert specs["layers.0.moe.router"] == (None, None)


FAMILIES = ["qwen2-moe-a2.7b", "olmoe-1b-7b", "paligemma-3b", "mamba2-2.7b",
            "zamba2-7b", "seamless-m4t-medium"]


@pytest.mark.parametrize("mesh_name", ["2x2", "2x4", "pod2x2x2"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_state_and_cache_specs_equal_reference(arch, mesh_name):
    """The other families' ``state_specs`` and ``api.cache_specs``,
    sanitized, equal the reference's leaf for leaf (every stacked group:
    ``layers``, ``enc_layers``, ``dec_layers``; the hybrid's
    ``shared_attn``; the mamba state, the cross K/V), under the training,
    serving and small-batch rules."""
    shape = MESHES[mesh_name]
    cfg, rcfg = get_config(arch), rget_config(arch)
    pm, fm = port_mesh(shape), FakeMesh(shape)
    target = _ref_target(rcfg)
    shapes = _port_flat_shapes(target["params"])
    for kw in ({}, {"serving": True}, {"small_batch": True}):
        rules, rrules = shd.make_rules(pm, cfg, **kw), rshd.make_rules(
            fm, rcfg, **kw)
        ours = tstep.state_specs(cfg, rules)
        want = _spec_leaves(rshd.sanitize_spec_tree(
            rstep.state_specs(rcfg, rrules), target, fm)["params"])
        assert sorted(ours["params"]) == sorted(shapes)
        for name, sp in ours["params"].items():
            san = shd.sanitize_spec(sp, shapes[name], pm)
            key = name.split(".")
            if key[0] in convert.STACKED:
                key, san = [key[0]] + key[2:], (None,) + san
            assert san == want["/".join(key)], (kw, name)
        B, S = 4, 64
        struct = rapi.cache_struct(rcfg, B, S)
        want = _spec_leaves(rshd.sanitize_spec_tree(
            rapi.cache_specs(rcfg, rrules), struct, fm))
        dims = {"/".join(str(p.key) for p in path): leaf.shape
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                    struct)[0]}
        got = _spec_leaves(jax.tree.map(
            lambda sp: P(*sp), api.cache_specs(cfg, rules),
            is_leaf=lambda x: isinstance(x, tuple)))
        assert got.pop("len") == want.pop("len") == ()
        leaves = sorted(k for k in want if not k.endswith("/len"))
        assert sorted(got) == leaves
        for k in leaves:
            assert shd.sanitize_spec(tuple(got[k]), dims[k], pm) == \
                want[k], (kw, k)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_mesh_state_layout_and_crossing(arch, tmp_path):
    """``init_state(mesh=)`` of every family on the (2, 2) mesh: each leaf
    a copy of its slice of the one-device state; a one-device trainer
    checkpoint restores onto the mesh, and the mesh's back onto one
    device, bit for bit (an elastic restore); and
    ``convert.lm_params_from_reference(tree, mesh=)`` shards the
    reference's parameters alike."""
    cfg = smoke_variant(get_config(arch))
    mesh = make_host_mesh(model=2, shards=4, device="cpu")
    one = tstep.init_state(cfg, 3, "cpu")
    state = tstep.init_state(cfg, 5, "cpu", mesh=mesh)
    flat = dict(one["params"].named_parameters())
    assert list(state["params"]) == list(flat)
    loop.save_train_state(str(tmp_path / "one"), 1, one,
                          extra={"data": {"step": 1}})
    loop.restore_train_state(str(tmp_path / "one"), state, verify=True)
    for name, sh in state["params"].items():
        for c, part in sh.parts.items():
            assert torch.equal(part.detach(), flat[name].detach()[
                shd._slices(sh.shape, sh.spec, mesh, c)]), (name, c)
    loop.save_train_state(str(tmp_path / "mesh"), 1, state,
                          extra={"data": {"step": 1}})
    back = tstep.init_state(cfg, 7, "cpu")
    loop.restore_train_state(str(tmp_path / "mesh"), back, verify=True)
    a = ckpt._flatten(loop.train_state_tree(back))
    b = ckpt._flatten(loop.train_state_tree(one))
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y)), k
    tree = convert.lm_params_to_reference(one["params"])
    specs = {n: sh.spec for n, sh in state["params"].items()}
    sharded = convert.lm_params_from_reference(tree, mesh, specs)
    for name, sh in sharded.items():
        assert sh.spec == specs[name]
        assert torch.equal(shd.unshard(sh), flat[name].detach()), name


# -- sharded tensors -------------------------------------------------------------

def _rand(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32))


@pytest.mark.parametrize("mesh_name", ["2x2", "2x4", "1x4", "pod2x2x2"])
def test_shard_holds_only_each_slice_and_unshards(mesh_name):
    pm = port_mesh(MESHES[mesh_name])
    x = _rand((8, 12, 4))
    axes = pm.axis_names
    for sp in [(axes[0], axes[-1], None), (None, (axes[0], axes[1]), None),
               ((axes[-1],) + tuple(axes[:-1]), None, None), (None,) * 3]:
        sp = shd.sanitize_spec(sp, x.shape, pm)
        sh = shd.shard(x, pm, sp)
        want = shd.local_shape(x.shape, sp, pm)
        for c, part in sh.parts.items():
            assert tuple(part.shape) == want
            assert part.untyped_storage().nbytes() == part.numel() * 4
            sl = shd._slices(x.shape, sp, pm, c)
            assert torch.equal(part, x[sl]), (sp, c)
        assert torch.equal(shd.unshard(sh), x)
        assert sum(t.numel() for t in sh.unique_parts()) == x.numel()
    with pytest.raises(ValueError, match="does not divide"):
        shd.shard(_rand((3, 4)), pm, (axes[-1], None)) if \
            shd.axes_size(pm, (axes[-1],)) > 1 else shd.shard(
                _rand((3, 4)), pm, ((axes[0], axes[-1]), None))


def _locals(pm, shape, seed):
    return {c: _rand(shape, seed + i).requires_grad_()
            for i, c in enumerate(shd.coords(pm))}


@pytest.mark.parametrize("mesh_name", ["2x2", "pod2x2x2"])
def test_collectives_and_their_transposes(mesh_name):
    """Values: an all-gather concatenates in index order, an all-reduce
    sums in index order (bf16 in bf16), a reduce-scatter is the sum's
    slices.  Autograd's transposes: an all-gather's gradient is the
    reduce-scatter of the cotangents, an all-reduce's their all-reduce.
    Bytes: as a ring moves them."""
    pm = port_mesh(MESHES[mesh_name])
    axes = shd.data_axes(pm)
    G = shd.axes_size(pm, axes)
    x = _locals(pm, (2, 3), 0)
    w = {c: _rand((2, 3 * G), 50 + i) for i, c in enumerate(x)}
    shd.reset_collective_bytes()
    g = shd.all_gather(x, pm, axes, 1)
    assert shd.collective_bytes()["all_gather"] == len(x) * (G - 1) * 24
    for c in x:
        members = shd.group(pm, c, axes)
        assert torch.equal(g[c], torch.cat([x[m] for m in members], 1))
    grads = torch.autograd.grad(sum((g[c] * w[c]).sum() for c in x),
                                [x[c] for c in x])
    for (c, t), got in zip(x.items(), grads):
        i = shd.index(pm, c, axes)
        want = sum(w[m][:, 3 * i:3 * i + 3] for m in shd.group(pm, c, axes))
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)

    r = shd.all_reduce(x, pm, axes)
    for c in x:
        members = shd.group(pm, c, axes)
        want = x[members[0]]
        for m in members[1:]:
            want = want + x[m]
        assert torch.equal(r[c], want)
    bf = {c: t.detach().to(torch.bfloat16) for c, t in x.items()}
    rb = shd.all_reduce(bf, pm, axes)
    assert all(t.dtype == torch.bfloat16 for t in rb.values())
    m = shd.all_reduce({c: t.detach() for c, t in x.items()}, pm, axes,
                       "max")
    for c in x:
        assert torch.equal(m[c], torch.stack(
            [x[k].detach() for k in shd.group(pm, c, axes)]).amax(0))

    y = _locals(pm, (2, 2 * G), 10)
    s = shd.reduce_scatter(y, pm, axes, 1)
    for c in y:
        i = shd.index(pm, c, axes)
        total = sum(y[k] for k in shd.group(pm, c, axes))
        torch.testing.assert_close(s[c], total[:, 2 * i:2 * i + 2],
                                   rtol=0, atol=1e-6)
    sp = shd.split({c: t.detach() for c, t in y.items()}, pm, axes, 1)
    for c in y:
        i = shd.index(pm, c, axes)
        assert torch.equal(sp[c], y[c].detach()[:, 2 * i:2 * i + 2])


# -- state on a mesh, resident bytes, elastic restore ----------------------------

def _tiny(cfg):
    return replace(cfg, num_layers=2, d_model=32, num_heads=2,
                   num_kv_heads=1, head_dim=16, d_ff=64, vocab_size=64)


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-4b"])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 4), (1, 4)])
def test_mesh_state_layout_and_resident_bytes(arch, mesh_shape):
    """``init_state(mesh=)``: each leaf laid out by its sanitized spec,
    every part the spec's local shape and a copy of its slice of the
    one-device state; each coordinate's params + moments bytes equal
    the sum the specs give (FSDP + TP leaves a fraction, the rest
    whole)."""
    cfg = smoke_variant(get_config(arch))
    mesh = make_host_mesh(model=mesh_shape[1],
                          shards=mesh_shape[0] * mesh_shape[1], device="cpu")
    one = tstep.init_state(cfg, 0, "cpu")
    state = tstep.init_state(cfg, 0, "cpu", mesh=mesh)
    rules = shd.make_rules(mesh, cfg)
    specs = tstep.state_specs(cfg, rules)["params"]
    flat = dict(one["params"].named_parameters())
    assert list(state["params"]) == list(flat)
    want = 0
    for name, sh in state["params"].items():
        sp = shd.sanitize_spec(specs[name], flat[name].shape, mesh)
        assert sh.spec == sp and sh.shape == tuple(flat[name].shape)
        lshape = shd.local_shape(sh.shape, sp, mesh)
        for c, part in sh.parts.items():
            assert tuple(part.shape) == lshape and part.requires_grad
            assert torch.equal(part.detach(), flat[name].detach()[
                shd._slices(sh.shape, sp, mesh, c)])
        want += 3 * 4 * int(np.prod(lshape))
    held = {}
    for tree in (state["params"], state["opt"]["mu"], state["opt"]["nu"]):
        for sh in tree.values():
            for c, t in sh.parts.items():
                held[c] = held.get(c, 0) + t.numel() * t.element_size()
    assert set(held.values()) == {want}
    total = 3 * 4 * sum(t.numel() for t in flat.values())
    assert want < total / 2 if mesh_shape != (1, 1) else want == total


@pytest.mark.parametrize("mesh_shape", [(2, 4), (1, 4)])
def test_reference_checkpoint_restores_onto_port_meshes(tmp_path,
                                                        mesh_shape):
    """A reference trainer checkpoint written on one device restores onto
    a port mesh: every part equals its slice of the saved arrays, bit for
    bit, and the unsharded state equals them."""
    rcfg, cfg = _tiny(rsmoke(rget_config("smollm-135m"))), _tiny(
        smoke_variant(get_config("smollm-135m")))
    rstate = rstep.init_state(rcfg, KEY)
    rstate = jax.tree.map(
        lambda a: a + 0.25 if a.dtype == np.float32 else a, rstate)
    rckpt.save(str(tmp_path), 3, rstate, extra={"data": {"step": 3}})
    mesh = make_host_mesh(model=mesh_shape[1],
                          shards=mesh_shape[0] * mesh_shape[1], device="cpu")
    state = tstep.init_state(cfg, 5, "cpu", mesh=mesh)
    extra = loop.restore_train_state(str(tmp_path), state, verify=True)
    assert extra["data"]["step"] == 3 and int(state["opt"]["step"]) == 0
    want = dict(ckpt._flatten(jax.tree.map(np.asarray, rstate)))
    got = dict(ckpt._flatten(loop.train_state_tree(state)))
    assert list(got) == list(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    mu = state["opt"]["mu"]["layers.1.mlp.wg"]
    full = torch.from_numpy(np.array(
        rstate["opt"]["mu"]["layers"]["mlp"]["wg"][1]))
    for c, part in mu.parts.items():
        assert torch.equal(part, full[shd._slices(mu.shape, mu.spec, mesh,
                                                  c)])


def test_port_mesh_checkpoint_reads_back_in_the_reference(tmp_path):
    """A port mesh state, saved (unsharded), restores in the reference
    unchanged; and the restore's placements shard each leaf from the
    bytes read (``checkpoint.restore(shardings=)``)."""
    cfg, rcfg = _tiny(smoke_variant(get_config("qwen3-4b"))), _tiny(
        rsmoke(rget_config("qwen3-4b")))
    mesh = make_host_mesh(model=2, shards=4, device="cpu")
    state = tstep.init_state(cfg, 2, "cpu", mesh=mesh)
    state["opt"]["mu"] = {n: sh.map(lambda t: t + 1.5)
                          for n, sh in state["opt"]["mu"].items()}
    loop.save_train_state(str(tmp_path), 7, state,
                          extra={"data": {"step": 7}})
    tree, extra = rckpt.restore(str(tmp_path), _ref_target(rcfg),
                                verify=True)
    assert extra["data"]["step"] == 7
    mine = dict(ckpt._flatten(loop.train_state_tree(state)))
    theirs = dict(ckpt._flatten(jax.tree.map(np.asarray, tree)))
    assert list(mine) == list(theirs)
    for k in mine:
        np.testing.assert_array_equal(mine[k].numpy(), theirs[k], err_msg=k)
    placed = {"params": convert.lm_tree({n: shd.Placement(sh.mesh, sh.spec)
                                         for n, sh in
                                         state["params"].items()})}
    back, _ = ckpt.restore(str(tmp_path), {"params": convert.lm_tree(
        {n: _stub(sh.shape) for n, sh in state["params"].items()})},
        device="cpu", shardings=placed)
    wq = back["params"]["layers"]["attn"]["wq"]
    assert isinstance(wq, shd.Sharded) and wq.spec[0] is None
    assert torch.equal(shd.unshard(wq[1]),
                       shd.unshard(state["params"]["layers.1.attn.wq"]))


def test_convert_crosses_sharded_params():
    """``convert.lm_params_{from,to}_reference`` take and give sharded
    parameters through ``shard``/``unshard``."""
    rcfg, cfg = rsmoke(rget_config("qwen3-4b")), smoke_variant(
        get_config("qwen3-4b"))
    tree = jax.tree.map(np.asarray, rapi.init_params(rcfg, KEY))
    mesh = make_host_mesh(model=2, shards=4, device="cpu")
    ctx = ShardCtx(mesh, shd.make_rules(mesh, cfg))
    shapes = {n: t.shape for n, t in
              convert.lm_params_from_reference(tree).items()}
    specs = {n: shd.sanitize_spec(s, shapes[n], mesh)
             for n, s in api.param_specs(cfg, ctx.rules).items()}
    sharded = convert.lm_params_from_reference(tree, mesh, specs)
    assert sharded["layers.0.mlp.wu"].parts[(0, 1)].shape == (32, 64)
    back = convert.lm_params_to_reference(sharded)
    for (k, a), (_, b) in zip(ckpt._flatten(back), ckpt._flatten(tree)):
        np.testing.assert_array_equal(a, b, err_msg=k)
