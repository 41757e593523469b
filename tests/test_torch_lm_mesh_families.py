"""The port's LM families on a device mesh, on meshes of repeated CPU
devices: olmoe-1b-7b (moe), mamba2-2.7b (ssm) and zamba2-7b (hybrid)
against the JAX package's own (data 2, model 2) mesh run and the port's
one-device run (``tests/lm_mesh_parity.py``: the reference runs in a
subprocess with four forced host devices, started with this module's
first test; tolerance ``FACTOR`` = 3 x the reference's own
mesh-vs-unsharded spread).  qwen2-moe's shared experts, the vlm and the
encdec are in ``tests/test_torch_lm_mesh_families_more.py``, so the two
reference runs go to two workers.

Block-level cases besides: a MoE capacity group that spans both data
coordinates drops exactly the (token, slot) pairs one device drops
while only the routing crosses the data axis; on data coordinates alone
the MoE is one device's bit for bit, whatever the groups' alignment;
and the mamba block's gated rms norm all-reduces its sum of squares over
the model axis."""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import sharding as shd  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.models import api, layers  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.common import ShardCtx  # noqa: E402
import lm_mesh_parity as P  # noqa: E402

ARCHS = ["olmoe-1b-7b", "mamba2-2.7b", "zamba2-7b"]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Started with the module's first test; ``reference()`` waits for the
    subprocess and returns its arrays."""
    wait, stop = P.start_reference(tmp_path_factory.mktemp("reference"),
                                   ARCHS)
    yield wait
    stop()


@pytest.fixture(scope="module", autouse=True)
def _start_reference(reference):
    yield


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference_mesh(arch, reference):
    P.check_train_vs_reference(arch, reference())


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4)])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_one_device(arch, mesh_shape, reference):
    P.check_train_vs_one_device(arch, mesh_shape, reference())


@pytest.mark.parametrize("b", [P.B, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_matches_reference_mesh(arch, b, reference):
    P.check_serving_vs_reference(arch, b, reference())


# -- block level: the same input on one device and on the (2, 2) mesh ------------

def _layer0(cfg, model, mesh):
    """Layer 0's bf16 weights on one device and, sharded by the training
    rules, on ``mesh``; the mesh's context."""
    ctx = ShardCtx(mesh, shd.make_rules(mesh, cfg))
    one = tf.layer_weights(dict(model.named_parameters()), "layers",
                           cfg.num_layers)[0]
    on_mesh = tf.layer_weights(api.shard_params(model, cfg, ctx), "layers",
                               cfg.num_layers)[0]
    return one, on_mesh, ctx


def _residual(cfg, seed=0):
    B, T = P.B, P.T
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(B, T, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)


def _run_sublayer(fn, lw, x, ctx):
    """``fn(lw, x_local, geo)`` on ``x`` laid out as the residual stream
    (``"batch", "seq_sp"``), the output unsharded."""
    sp = ctx.spec(x.shape, "batch", "seq_sp", None)
    geo = tf.geo_of(ctx, x.shape[0], x.shape[1])
    out = fn(lw, shd.shard(x, ctx.mesh, sp).parts, geo)
    if isinstance(out, tuple):
        out = out[0]
    return shd.unshard(shd.Sharded(out, x.shape, sp, ctx.mesh))


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def _moe_on(cfg, model, mesh, x):
    """Layer 0's MoE sublayer on one device and on ``mesh`` from ``x``:
    (one device's output, the mesh's, their routing logs, the shapes
    the mesh all-gathered along their first dim over its data axis: the
    weights' fsdp shards are gathered along another)."""
    ctx = ShardCtx(mesh, shd.make_rules(mesh, cfg))
    one = tf.layer_weights(dict(model.named_parameters()), "layers",
                           cfg.num_layers)[0]
    on_mesh = tf.layer_weights(api.shard_params(model, cfg, ctx), "layers",
                               cfg.num_layers)[0]
    with layers.routing_log() as log1:
        y1, _ = tf.moe_sublayer(one, {(): x}, cfg, tf.Geo(None, (), ()),
                                False)
    gathered = []
    all_gather = shd.all_gather

    def spy(parts, mesh, axes, dim):
        if tuple(axes) == ("data",) and dim == 0:
            gathered.append({(tuple(t.shape), t.dtype)
                             for t in parts.values()})
        return all_gather(parts, mesh, axes, dim)

    shd.all_gather = spy
    try:
        with layers.routing_log() as logm:
            ym = _run_sublayer(lambda lw, xl, geo: tf.moe_sublayer(
                lw, xl, cfg, geo, False), on_mesh, x, ctx)
    finally:
        shd.all_gather = all_gather
    return y1[()], ym, log1, logm, gathered


@torch.no_grad()
def test_moe_group_across_data_shards_drops_as_one_device():
    """olmoe's smoke MoE with one capacity group of exactly the batch's
    B*T = 128 tokens, which spans both data coordinates, and a capacity
    factor of 1 (C = 64 slots an expert, so some pairs drop): on the
    (2, 2) mesh, from the same input, the data axis shares only the
    routing (each coordinate's tokens' probabilities and top-k experts),
    the mesh keeps exactly the (token, slot) pairs one device keeps, and
    the block's output agrees with one device's within the bf16 rounding
    of the experts' partial sums (relative L2 <= 1e-2).  Routing each
    data shard's tokens as groups of their own would drop other pairs."""
    cfg = replace(smoke_variant(get_config("olmoe-1b-7b")),
                  moe_group_size=P.B * P.T, capacity_factor=1.0)
    model = api.init_params(cfg, 0, "cpu")
    x = _residual(cfg)
    y1, ym, log1, logm, gathered = _moe_on(cfg, model, P.mesh22(), x)
    (r1,), (rm,) = log1, logm
    kept1 = r1["kept"].reshape(-1, cfg.top_k)
    assert 0 < int((~kept1).sum()) < kept1.numel()
    assert torch.equal(rm["kept"], r1["kept"])
    assert torch.equal(rm["top_e"], r1["top_e"])
    N_l, E, k = P.B * P.T // 2, cfg.eff_num_experts, cfg.top_k
    # the normed input (the residual is split on the sequence over the
    # model axis, not the data axis) never crosses the data axis
    assert gathered == [{((N_l, E), torch.float32)},
                        {((N_l, k), torch.int64)}]
    h1, hm = y1.float() - x.float(), ym.float() - x.float()
    assert _rel(hm, h1) <= 1e-2, _rel(hm, h1)
    # a group per data shard (each shard's 64 tokens padded to 128) keeps
    # other pairs
    one = tf.layer_weights(dict(model.named_parameters()), "layers",
                           cfg.num_layers)[0]
    per_shard = []
    for half in (x[:2], x[2:]):
        xg = torch.nn.functional.pad(half.reshape(-1, cfg.d_model),
                                     (0, 0, 0, P.B * P.T // 2))
        _, _, top_e = layers.moe_router(one["moe"], xg, cfg)
        _, kept = layers.queue_positions(
            top_e[None], cfg.eff_num_experts,
            layers.capacity(cfg, cfg.moe_group_size))
        per_shard.append(kept[0, :P.B * P.T // 2])
    assert not torch.equal(torch.cat(per_shard), kept1)


@pytest.mark.parametrize("group", [128, 64, 48])
@torch.no_grad()
def test_moe_data_shards_are_one_device_bit_for_bit(group):
    """On a mesh of 4 data coordinates and no model axis (each holds one
    batch row, every expert), olmoe's smoke MoE with groups of ``group``
    tokens (one group over all four coordinates; one over two; groups
    that straddle the coordinates' rows, the last padded) and capacity
    factor 1: each coordinate dispatches only its own tokens (to their
    slots of the batch's queues), yet its output and its drops are one
    device's bit for bit."""
    from repro_torch.launch.mesh import make_host_mesh
    cfg = replace(smoke_variant(get_config("olmoe-1b-7b")),
                  moe_group_size=group, capacity_factor=1.0)
    model = api.init_params(cfg, 0, "cpu")
    x = _residual(cfg, seed=1)
    mesh = make_host_mesh(model=1, shards=4, device="cpu")
    y1, ym, log1, logm, _ = _moe_on(cfg, model, mesh, x)
    assert int((~log1[0]["kept"]).sum()) > 0
    assert torch.equal(logm[0]["kept"], log1[0]["kept"])
    assert torch.equal(ym, y1)


@torch.no_grad()
def test_mamba_gated_norm_all_reduces_over_the_model_axis(monkeypatch):
    """mamba2's smoke layer on the (2, 2) mesh: each coordinate holds 4 of
    the 8 SSM heads, and the gated rms norm over ``d_inner`` = 128
    all-reduces each coordinate's sum of squares ([B/2, T, 1] f32) over
    the model axis; the layer's output equals one device's within the
    bf16 rounding of the row-parallel partial sums (relative L2 <= 1e-2).
    A norm over each coordinate's own heads alone is off by more than
    ten times that."""
    cfg = smoke_variant(get_config("mamba2-2.7b"))
    model = api.init_params(cfg, 0, "cpu")
    one, on_mesh, ctx = _layer0(cfg, model, P.mesh22())
    assert tf.mamba_heads(on_mesh["mamba"], cfg, ctx.mesh) == ("model",)
    x = _residual(cfg)
    h1 = tf.mamba_sublayer(one, {(): x}, cfg, tf.Geo(None, (), ()))[()] \
        .float() - x.float()
    reduced = []
    all_reduce = shd.all_reduce

    def spy(parts, mesh, axes, op="sum"):
        reduced.append((tuple(axes), {tuple(t.shape) for t in parts.values()},
                        {t.dtype for t in parts.values()}))
        return all_reduce(parts, mesh, axes, op)

    monkeypatch.setattr(shd, "all_reduce", spy)

    def run(lw, xl, geo):
        return tf.mamba_sublayer(lw, xl, cfg, geo)

    hm = _run_sublayer(run, on_mesh, x, ctx).float() - x.float()
    assert (("model",), {(P.B // 2, P.T, 1)}, {torch.float32}) in reduced
    assert _rel(hm, h1) <= 1e-2, _rel(hm, h1)
    out = tf.mamba_out
    monkeypatch.setattr(tf, "mamba_out",
                        lambda p, y, cfg, sumsq=None: out(p, y, cfg))
    local = _run_sublayer(run, on_mesh, x, ctx).float() - x.float()
    assert _rel(local, h1) > 0.1, _rel(local, h1)
