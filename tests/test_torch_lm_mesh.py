"""The port's LM on a device mesh, on meshes of repeated CPU devices,
against the JAX package's own mesh run and the port's one-device run.

The reference runs in a subprocess with four forced host devices (as
``tests/test_substrate.py``'s elastic-restore test does), started with
this module's first test: its jitted train step, prefill and decode on
a (data 2, model 2) mesh and unsharded, from the seed-0 parameters of
the smoke variants of smollm-135m (attention replicated, FFN and vocab
on the model axis, tied) and qwen3-4b (heads on the model axis,
``qk_norm``, untied).  The port's mesh run must agree with the
reference's mesh run within ``FACTOR`` times the reference's own
mesh-vs-unsharded spread: the bf16 partial sums of the row-parallel
products and the reduce-scatters round as XLA's do.  ``NO_SHARD`` is
the one-device path, bit for bit."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as rget_config  # noqa: E402
from repro.configs import smoke_variant as rsmoke  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import sharding as shd  # noqa: E402
from repro_torch.configs import get_config, smoke_variant  # noqa: E402
from repro_torch.core.distributed import Mesh  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch import serve as lserve  # noqa: E402
from repro_torch.launch import train as ltrain  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.common import NO_SHARD, ShardCtx  # noqa: E402
from repro_torch.train import loop, optim  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
KEY = jax.random.PRNGKey(0)
ARCHS = ["smollm-135m", "qwen3-4b"]
B, T, PROMPT, MAX_LEN = 4, 32, 16, 24
# the port's mesh run within FACTOR x the reference's own mesh-vs-unsharded
# spread (loss, grad norm, the update's relative L2, logits' max |diff|):
# bf16 partial sums that autograd adds in another order than XLA; the
# largest ratio measured is 2.4 (qwen3's grad norm, the port's mesh step
# against its one-device step: 3.9e-3 against the reference's 1.6e-3)
FACTOR = 3.0
OPT = dict(warmup_steps=1)   # step 1 at the full lr: the update is visible

REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import get_config, smoke_variant
    from repro.models import api
    from repro.sharding import make_rules, sanitize_spec_tree
    from repro.train import optim, step as tstep
    B, T, PROMPT, MAX_LEN = {B}, {T}, {PROMPT}, {MAX_LEN}
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    res = {{}}

    def put(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(getattr(p, "key", p)) for p in path)
            res[prefix + key] = np.asarray(jax.device_get(leaf), np.float32)

    for arch in {ARCHS!r}:
        cfg = smoke_variant(get_config(arch))
        rng = np.random.default_rng(0)
        batch = {{k: jnp.asarray(rng.integers(0, cfg.vocab_size, (B, T)),
                                 jnp.int32) for k in ("tokens", "labels")}}
        params = api.init_params(cfg, jax.random.PRNGKey(0))
        state = {{"params": params, "opt": optim.init(params)}}
        specs = sanitize_spec_tree(
            tstep.state_specs(cfg, make_rules(mesh, cfg)),
            jax.eval_shape(lambda: state), mesh)
        placed = jax.device_put(state, jax.tree.map(
            lambda s: NamedSharding(mesh, s), specs,
            is_leaf=lambda x: isinstance(x, P)))
        for name, m, st in (("mesh", mesh, placed), ("one", None, state)):
            new, met = jax.jit(tstep.make_train_step(
                cfg, optim.AdamWConfig(warmup_steps=1), m))(st, batch)
            res[f"{{arch}}/{{name}}/loss"] = np.float32(met["loss"])
            res[f"{{arch}}/{{name}}/grad_norm"] = np.float32(met["grad_norm"])
            put(f"{{arch}}/{{name}}/params/", new["params"])
            for b, small in ((B, False), (1, True)):
                pre = jax.jit(tstep.make_prefill_step(cfg, MAX_LEN, m,
                                                      small_batch=small))
                dec = jax.jit(tstep.make_serve_step(cfg, m,
                                                    small_batch=small))
                lg, cache = pre(params, {{"tokens": batch["tokens"][:b,
                                                                   :PROMPT]}})
                nxt = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
                lg2, _ = dec(params, cache, nxt)
                res[f"{{arch}}/{{name}}/prefill{{b}}"] = np.asarray(
                    lg, np.float32)
                res[f"{{arch}}/{{name}}/next{{b}}"] = np.asarray(nxt)
                res[f"{{arch}}/{{name}}/decode{{b}}"] = np.asarray(
                    lg2, np.float32)
    np.savez(sys.argv[1], **res)
    print("REFERENCE_OK")
""").format(B=B, T=T, PROMPT=PROMPT, MAX_LEN=MAX_LEN, ARCHS=ARCHS)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Started with the module's first test; ``reference()`` waits for the
    subprocess and returns its arrays."""
    out = tmp_path_factory.mktemp("reference") / "mesh.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE, str(out)],
                            env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    got = {}

    def wait():
        if not got:
            stdout, stderr = proc.communicate(timeout=400)
            assert "REFERENCE_OK" in stdout, stdout + stderr
            got.update(np.load(out))
        return got

    yield wait
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def _start_reference(reference):
    yield


def mesh22():
    return make_host_mesh(model=2, shards=4, device="cpu")


def batch(cfg):
    rng = np.random.default_rng(0)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T)))
            for k in ("tokens", "labels")}


def ref_model(arch):
    """The port model with the reference's seed-0 smoke parameters, and
    those parameters as numpy."""
    cfg = smoke_variant(get_config(arch))
    rparams = jax.tree.map(np.asarray,
                           rapi.init_params(rsmoke(rget_config(arch)), KEY))
    model = api.init_params(cfg, 1, "cpu")
    model.load_state_dict(convert.lm_params_from_reference(rparams))
    return cfg, model, rparams


def one_step(cfg, model, mesh=None):
    """One train step from ``model``'s weights, on one device or on the
    mesh: (metrics, updated parameters as the reference's flat tree)."""
    if mesh is None:
        state = {"params": model,
                 "opt": optim.init(dict(model.named_parameters()))}
    else:
        ctx = ShardCtx(mesh, shd.make_rules(mesh, cfg))
        params = api.shard_params(model, cfg, ctx, requires_grad=True)
        state = {"params": params, "opt": optim.init(params)}
    fn = tstep.make_train_step(cfg, optim.AdamWConfig(**OPT), mesh=mesh)
    state, metrics = fn(state, batch(cfg))
    tree = convert.lm_params_to_reference(state["params"])
    return metrics, state, dict(ckpt._flatten(tree))


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def updates(flat, rflat0):
    return np.concatenate([(np.asarray(flat[k], np.float32) - rflat0[k])
                           .ravel() for k in sorted(rflat0)])


# -- the one-device path, the layouts, the launchers -------------------------------

def test_no_shard_is_the_one_device_path():
    """``ctx=NO_SHARD`` (the default) is the one-device forward, loss and
    decode, bit for bit."""
    cfg, model, _ = ref_model("qwen3-4b")
    toks = batch(cfg)["tokens"]
    with torch.no_grad():
        a = tf.forward(model, cfg, toks)[0]
        b = tf.forward(model, cfg, toks, ctx=NO_SHARD)[0]
        assert torch.equal(a, b)
        la = api.loss_fn(model, batch(cfg), cfg)[0]
        lb = api.loss_fn(model, batch(cfg), cfg, NO_SHARD)[0]
        assert torch.equal(la, lb)
        pa, ca = api.prefill_fn(model, {"tokens": toks}, cfg, MAX_LEN + 8)
        pb, cb = api.prefill_fn(model, {"tokens": toks}, cfg, MAX_LEN + 8,
                                NO_SHARD)
        assert torch.equal(pa, pb) and torch.equal(ca["kv"]["k"],
                                                   cb["kv"]["k"])


@pytest.mark.parametrize("arch", ARCHS)
def test_no_coordinate_holds_the_full_ffn_or_vocab(arch, monkeypatch):
    """On a (2, 2) mesh every coordinate's FFN up-projection is
    ``d_ff / 2`` wide, its attention heads are its shard's (qwen3) or all
    of them (smollm, replicated), and its logits in the loss are
    ``[B / 2, T, V / 2]``: no coordinate materialises the full vocab."""
    cfg = smoke_variant(get_config(arch))
    mesh = mesh22()
    seen = {"wu": set(), "wq": set(), "logits": set(), "embed": set()}
    mlp, attn, xent = tf.mlp_block, tf.attention_block, \
        api.softmax_xent_sharded

    def rec_mlp(p, x):
        seen["wu"].add(tuple(p["wu"].shape))
        return mlp(p, x)

    def rec_attn(p, x, *a, **k):
        seen["wq"].add(tuple(p["wq"].shape))
        return attn(p, x, *a, **k)

    def rec_xent(logits, labels):
        seen["logits"].update(tuple(t.shape) for t in logits.parts.values())
        return xent(logits, labels)

    monkeypatch.setattr(tf, "mlp_block", rec_mlp)
    monkeypatch.setattr(tf, "attention_block", rec_attn)
    monkeypatch.setattr(api, "softmax_xent_sharded", rec_xent)
    state = tstep.init_state(cfg, 0, "cpu", mesh=mesh)
    fn = tstep.make_train_step(cfg, optim.AdamWConfig(), mesh=mesh)
    fn(state, batch(cfg))
    d, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_padded
    H, Dh = cfg.eff_num_heads, cfg.head_dim
    assert seen["wu"] == {(d, F // 2)}
    assert seen["wq"] == {(d, H // 2 if cfg.shard_attn_heads else H, Dh)}
    assert seen["logits"] == {(B // 2, T, V // 2)}
    emb = state["params"]["embed"]
    assert {tuple(t.shape) for t in emb.parts.values()} == {(V // 2, d // 2)}


def test_mesh_of_another_device_kind_or_family_raises():
    """A mesh of another device kind than the trainer's, and a model axis
    that does not divide the devices, raise; every family runs on the
    mesh now: olmoe's smoke variant inits and steps on the (2, 2) mesh,
    its experts split over the model axis and its aux loss reported."""
    cfg = smoke_variant(get_config("smollm-135m"))
    data = SyntheticLM(cfg.vocab_size, 8, 2)
    other = Mesh([["cuda:0", "cuda:0"]], ("data", "model"))
    with pytest.raises(ValueError, match="cuda"):
        loop.train(cfg, data, 1, device="cpu", mesh=other, log_fn=print)
    moe = smoke_variant(get_config("olmoe-1b-7b"))
    state = tstep.init_state(moe, 0, "cpu", mesh=mesh22())
    wg = state["params"]["layers.0.moe.wg"]
    assert wg.spec == ("model", "data", None)
    assert {tuple(t.shape) for t in wg.parts.values()} == {
        (moe.eff_num_experts // 2, moe.d_model // 2, moe.expert_d_ff)}
    fn = tstep.make_train_step(moe, optim.AdamWConfig(), mesh=mesh22())
    state, m = fn(state, batch(moe))
    assert np.isfinite(float(m["loss"])) and float(m["moe_aux"]) > 0
    assert isinstance(state["params"]["embed"], shd.Sharded)
    with pytest.raises(ValueError, match="does not divide"):
        make_host_mesh(model=3, shards=4, device="cpu")


@pytest.mark.parametrize("arch,mesh_shape", [
    pytest.param("qwen3-4b", (2, 2), id="mesh_shape0"),
    pytest.param("qwen3-4b", (1, 4), id="mesh_shape1"),
    pytest.param("zamba2-7b", (2, 2), id="zamba2-7b")])
def test_mesh_resume_after_failure_is_exact(tmp_path, arch, mesh_shape):
    """``loop.train(mesh=)`` failing at step 3 and resuming from its step-2
    checkpoint ends in the uninterrupted mesh run's state
    (``rtol=1e-5, atol=1e-6``) and losses: the dense qwen3 on two
    meshes, and the hybrid (mamba layers, the shared attention block) on
    the (2, 2) mesh."""
    cfg = smoke_variant(get_config(arch))
    mesh = make_host_mesh(model=mesh_shape[1], shards=4, device="cpu")
    data = SyntheticLM(cfg.vocab_size, 16, 4)
    kw = dict(num_steps=6, save_every=2, log_every=0, log_fn=lambda s: None,
              device="cpu", mesh=mesh)
    with pytest.raises(RuntimeError, match="simulated preemption"):
        loop.train(cfg, data, ckpt_dir=str(tmp_path), fail_at_step=3, **kw)
    resumed = loop.train(cfg, data, ckpt_dir=str(tmp_path), **kw)
    straight = loop.train(cfg, data, ckpt_dir=None, **kw)
    assert resumed.resumed_from == 2 and resumed.steps_run == 4
    assert resumed.losses == straight.losses[2:]
    a = ckpt._flatten(loop.train_state_tree(resumed.state))
    b = ckpt._flatten(loop.train_state_tree(straight.state))
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert isinstance(resumed.state["params"]["embed"], shd.Sharded)


def test_launchers_run_on_a_mesh(tmp_path):
    """``launch.train`` and ``launch.serve`` with ``--shards 4
    --model-axis 2`` (and a batch below the data axes, ``small_batch``)."""
    cfg, rep = ltrain.run(
        ["--arch", "smollm-135m", "--smoke", "--steps", "3", "--seq", "16",
         "--batch", "4", "--shards", "4", "--model-axis", "2", "--device",
         "cpu", "--ckpt", str(tmp_path / "t"), "--save-every", "2"],
        log_fn=lambda s: None)
    assert rep.steps_run == 3 and np.isfinite(rep.losses).all()
    assert ckpt.all_steps(str(tmp_path / "t")) == [2, 3]
    assert isinstance(rep.state["params"]["embed"], shd.Sharded)
    for b in (2, 1):
        out, params, prompt = lserve.run(
            ["--arch", "qwen3-4b", "--smoke", "--batch", str(b),
             "--prompt-len", "8", "--gen", "3", "--shards", "4",
             "--model-axis", "2", "--device", "cpu"])
        assert out["finite"] and out["mesh"] == {"data": 2, "model": 2}
        assert out["small_batch"] == (b == 1) and len(out["sample"]) == 3
        assert isinstance(params["layers.0.attn.wq"], shd.Sharded)
        assert params["layers.0.attn.wq"].dtype == torch.bfloat16
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "smollm-135m", "--smoke", "--steps", "2", "--seq", "8", "--batch",
         "2", "--shards", "4", "--model-axis", "2", "--device", "cpu"],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1])["steps_run"] == 2


# -- against the reference's mesh run, and the port's one-device run ---------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference_mesh(arch, reference):
    """One train step on the (2, 2) mesh from the reference's weights: the
    loss, the gradient norm and the parameter update agree with the
    reference's mesh step within ``FACTOR`` x its own mesh-vs-unsharded
    spread; every replica of a leaf is equal after the step."""
    ref = reference()
    cfg, model, rparams = ref_model(arch)
    rflat0 = dict(ckpt._flatten(rparams))
    metrics, state, flat = one_step(cfg, model, mesh22())
    for key in ("loss", "grad_norm"):
        spread = abs(ref[f"{arch}/mesh/{key}"] - ref[f"{arch}/one/{key}"])
        got = abs(float(metrics[key]) - ref[f"{arch}/mesh/{key}"])
        assert got <= FACTOR * spread, (key, got, spread)
    rm = updates({k: ref[f"{arch}/mesh/params/{k}"] for k in rflat0}, rflat0)
    r1 = updates({k: ref[f"{arch}/one/params/{k}"] for k in rflat0}, rflat0)
    got = rel_l2(updates(flat, rflat0), rm)
    assert got <= FACTOR * rel_l2(rm, r1), (got, rel_l2(rm, r1))
    for name, sh in state["params"].items():
        rep = sh.replica_axes()
        for c, part in sh.parts.items():
            root = list(c)
            for a in rep:
                root[sh.mesh.axis_names.index(a)] = 0
            assert torch.equal(part, sh.parts[tuple(root)]), (name, c)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 4), (2, 4)])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_one_device(arch, mesh_shape, reference):
    """The port's mesh step against its one-device step from the same
    weights and batch, within ``FACTOR`` x the reference's (2, 2)
    spread; on (1, 4) and (2, 4) qwen3's 2 KV heads do not divide the
    model axis, so its attention runs replicated there."""
    ref = reference()
    cfg, model, rparams = ref_model(arch)
    rflat0 = dict(ckpt._flatten(rparams))
    mesh = make_host_mesh(model=mesh_shape[1],
                          shards=mesh_shape[0] * mesh_shape[1], device="cpu")
    m_mesh, _, f_mesh = one_step(cfg, model, mesh)
    _, model, _ = ref_model(arch)
    m_one, _, f_one = one_step(cfg, model)
    for key in ("loss", "grad_norm"):
        spread = abs(ref[f"{arch}/mesh/{key}"] - ref[f"{arch}/one/{key}"])
        got = abs(float(m_mesh[key]) - float(m_one[key]))
        assert got <= FACTOR * spread, (key, got, spread)
    rm = updates({k: ref[f"{arch}/mesh/params/{k}"] for k in rflat0}, rflat0)
    r1 = updates({k: ref[f"{arch}/one/params/{k}"] for k in rflat0}, rflat0)
    got = rel_l2(updates(f_mesh, rflat0), updates(f_one, rflat0))
    assert got <= FACTOR * rel_l2(rm, r1), (got, rel_l2(rm, r1))


@pytest.mark.parametrize("b", [B, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_matches_reference_mesh(arch, b, reference):
    """Prefill (bf16 weights, the serving rules; at B = 1 below the data
    axes, ``small_batch``: the cache's sequence on the data axes) and one
    decode step of the reference mesh's greedy token on the (2, 2) mesh:
    the logits agree with the reference's mesh logits within ``FACTOR``
    x its own mesh-vs-unsharded spread (max |diff|)."""
    ref = reference()
    cfg, model, _ = ref_model(arch)
    mesh = mesh22()
    small = b < 2
    pre = tstep.make_prefill_step(cfg, MAX_LEN, mesh=mesh, small_batch=small)
    dec = tstep.make_serve_step(cfg, mesh=mesh, small_batch=small)
    params = api.shard_params(model, cfg, pre.ctx, dtype=torch.bfloat16)
    logits, cache = pre(params, {"tokens": batch(cfg)["tokens"][:b,
                                                                :PROMPT]})
    rules = shd.make_rules(mesh, cfg, small_batch=small, serving=True)
    want_spec = shd.sanitize_spec(
        api.cache_specs(cfg, rules)["kv"]["k"],
        (cfg.num_layers, b, MAX_LEN, cfg.eff_num_kv_heads, cfg.head_dim),
        mesh)
    assert cache["kv"]["k"].spec == want_spec
    assert (want_spec[2] == "data") == small
    # the reference's greedy token, so both decode the same input
    nxt = torch.from_numpy(ref[f"{arch}/mesh/next{b}"]).long()
    step, _ = dec(params, cache, nxt)
    for name, got in (("prefill", logits), ("decode", step)):
        want = ref[f"{arch}/mesh/{name}{b}"]
        spread = np.abs(want - ref[f"{arch}/one/{name}{b}"]).max()
        err = np.abs(shd.unshard(got).float().numpy() - want).max()
        assert err <= FACTOR * spread, (name, err, spread)
