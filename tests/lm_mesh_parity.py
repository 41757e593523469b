"""Shared by the LM family mesh tests: the JAX package's own mesh run of
the smoke variants in a subprocess with four forced host devices (a
(data 2, model 2) mesh), and the port's train step and serving on its
meshes of repeated CPU devices, held to that run.

The reference subprocess trains one step on the mesh and unsharded from
the seed-0 parameters on ``lm_parity.smoke_batch``'s batches of seeds
``SEEDS`` (written to a file by the parent, so both packages read the
same numbers), then prefills ``PROMPT`` tokens of the seed-0 batch (and
a vlm's patches, an encdec's frames) and decodes one greedy token at B
and at 1 (``small_batch``).  The port runs the seed-0 batch, and its
numbers must sit within ``FACTOR`` times the reference's own
mesh-vs-unsharded spread of the same quantity.  A train step's spread
is the largest over the seeds: at these sizes a token whose top-k
experts are near a tie routes differently when the bf16 partial sums
round another way, on either package's mesh (the reference's seed-0
spread of qwen2-moe's loss is 1.8e-4; over seeds 0-3 it reaches
1.8e-3)."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch import convert
from repro_torch import sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import api
from repro_torch.models.common import ShardCtx
from repro_torch.train import optim
from repro_torch.train import step as tstep
from lm_parity import pair, smoke_batch, to_torch

ROOT = Path(__file__).resolve().parents[1]
B, T, PROMPT, GEN_ROOM = 4, 32, 16, 8
SEEDS = (0, 1, 2, 3)
# the port's numbers within FACTOR x the reference's own mesh-vs-unsharded
# spread (loss, grad norm, the update's relative L2, logits' max |diff|),
# as the dense family's mesh tests hold them (tests/test_torch_lm_mesh.py)
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
    PROMPT, GEN_ROOM, SEEDS = {PROMPT}, {GEN_ROOM}, {SEEDS!r}
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    batches = np.load(sys.argv[2])
    res = {{}}

    def flat(tree):
        return {{"/".join(str(getattr(p, "key", p)) for p in path):
                np.asarray(jax.device_get(leaf), np.float32)
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                    tree)[0]}}

    def update(new, old):
        return np.concatenate([(new[k] - old[k]).ravel()
                               for k in sorted(old)])

    for arch in sys.argv[3].split(","):
        cfg = smoke_variant(get_config(arch))

        def batch_of(seed):
            pre = f"{{arch}}/{{seed}}/"
            return {{k[len(pre):]: jnp.asarray(
                v, jnp.bfloat16 if v.dtype == np.float32 else jnp.int32)
                for k, v in batches.items() if k.startswith(pre)}}

        params = api.init_params(cfg, jax.random.PRNGKey(0))
        flat0 = flat(params)
        state = {{"params": params, "opt": optim.init(params)}}
        specs = sanitize_spec_tree(
            tstep.state_specs(cfg, make_rules(mesh, cfg)),
            jax.eval_shape(lambda: state), mesh)
        placed = jax.device_put(state, jax.tree.map(
            lambda s: NamedSharding(mesh, s), specs,
            is_leaf=lambda x: isinstance(x, P)))
        steps = {{name: jax.jit(tstep.make_train_step(
            cfg, optim.AdamWConfig(warmup_steps=1), m))
            for name, m in (("mesh", mesh), ("one", None))}}
        spread = {{}}
        for seed in SEEDS:
            got = {{}}
            for name, st in (("mesh", placed), ("one", state)):
                new, met = steps[name](st, batch_of(seed))
                got[name] = {{k: np.float32(v) for k, v in met.items()
                             if k in ("loss", "grad_norm", "moe_aux")}}
                got[name]["params"] = flat(new["params"])
                if seed == 0:
                    for k, v in got[name].items():
                        if k != "params":
                            res[f"{{arch}}/{{name}}/{{k}}"] = v
                    for k, v in got[name]["params"].items():
                        res[f"{{arch}}/{{name}}/params/{{k}}"] = v
            for k in got["one"]:
                if k != "params":
                    d = abs(got["mesh"][k] - got["one"][k])
                    spread[k] = max(spread.get(k, 0.0), d)
            um = update(got["mesh"]["params"], flat0)
            u1 = update(got["one"]["params"], flat0)
            d = np.linalg.norm(um - u1) / np.linalg.norm(u1)
            spread["update"] = max(spread.get("update", 0.0), d)
        for k, v in spread.items():
            res[f"{{arch}}/spread/{{k}}"] = np.float64(v)

        batch = batch_of(0)
        prompt = {{k: v for k, v in batch.items()
                   if k in ("patch_embeds", "frames")}}
        prompt["tokens"] = batch["tokens"][:, :PROMPT]
        max_len = PROMPT + cfg.num_prefix_embeds + GEN_ROOM
        for name, m in (("mesh", mesh), ("one", None)):
            for b, small in (({B}, False), (1, True)):
                pre = jax.jit(tstep.make_prefill_step(cfg, max_len, m,
                                                      small_batch=small))
                dec = jax.jit(tstep.make_serve_step(cfg, m,
                                                    small_batch=small))
                lg, cache = pre(params, {{k: v[:b] for k, v in
                                          prompt.items()}})
                nxt = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
                lg2, _ = dec(params, cache, nxt)
                res[f"{{arch}}/{{name}}/prefill{{b}}"] = np.asarray(
                    lg, np.float32)
                res[f"{{arch}}/{{name}}/next{{b}}"] = np.asarray(nxt)
                res[f"{{arch}}/{{name}}/decode{{b}}"] = np.asarray(
                    lg2, np.float32)
    np.savez(sys.argv[1], **res)
    print("REFERENCE_OK")
""").format(B=B, PROMPT=PROMPT, GEN_ROOM=GEN_ROOM, SEEDS=SEEDS)


def batch_np(cfg, seed: int = 0):
    return smoke_batch(cfg, B=B, T=T, seed=seed)


def start_reference(tmp_dir: Path, archs):
    """Start the reference's mesh run of ``archs``; returns ``wait()``,
    which waits for it and returns its arrays, and ``stop()``."""
    from repro_torch.configs import get_config, smoke_variant
    inputs = tmp_dir / "batches.npz"
    np.savez(inputs, **{f"{a}/{seed}/{k}": v for a in archs
                        for seed in SEEDS for k, v in batch_np(
                            smoke_variant(get_config(a)), seed).items()})
    out = tmp_dir / "mesh.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(out), str(inputs),
         ",".join(archs)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    got = {}

    def wait():
        if not got:
            stdout, stderr = proc.communicate(timeout=600)
            assert "REFERENCE_OK" in stdout, stdout + stderr
            got.update(np.load(out))
        return got

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()

    return wait, stop


def mesh22():
    return make_host_mesh(model=2, shards=4, device="cpu")


def ref_model(arch):
    """(port cfg, the port model with the reference's seed-0 smoke
    parameters, those parameters as numpy)."""
    cfg, _, rparams, model = pair(arch)
    return cfg, model, jax.tree.map(np.asarray, rparams)


def one_step(cfg, model, mesh=None):
    """One train step from ``model``'s weights on ``batch_np``'s batch, on
    one device or on the mesh: (metrics, state, updated parameters as
    the reference's flat tree)."""
    if mesh is None:
        state = {"params": model,
                 "opt": optim.init(dict(model.named_parameters()))}
    else:
        ctx = ShardCtx(mesh, shd.make_rules(mesh, cfg))
        params = api.shard_params(model, cfg, ctx, requires_grad=True)
        state = {"params": params, "opt": optim.init(params)}
    fn = tstep.make_train_step(cfg, optim.AdamWConfig(**OPT), mesh=mesh)
    state, metrics = fn(state, to_torch(batch_np(cfg)))
    tree = convert.lm_params_to_reference(state["params"])
    return metrics, state, dict(ckpt._flatten(tree))


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def updates(flat, rflat0):
    return np.concatenate([(np.asarray(flat[k], np.float32) - rflat0[k])
                           .ravel() for k in sorted(rflat0)])


def _scalars(cfg):
    return ("loss", "grad_norm") + (("moe_aux",) if cfg.family == "moe"
                                    else ())


def check_train_vs_reference(arch, ref):
    """One train step on the (2, 2) mesh from the reference's weights: the
    loss (and a moe's aux loss), the gradient norm and the parameter
    update (relative L2) agree with the reference's mesh step within
    ``FACTOR`` x its own mesh-vs-unsharded spread; every replica of a
    leaf is equal after the step."""
    cfg, model, rparams = ref_model(arch)
    rflat0 = dict(ckpt._flatten(rparams))
    metrics, state, flat = one_step(cfg, model, mesh22())
    for key in _scalars(cfg):
        spread = ref[f"{arch}/spread/{key}"]
        got = abs(float(metrics[key]) - ref[f"{arch}/mesh/{key}"])
        assert got <= FACTOR * spread, (key, got, spread)
    rm = updates({k: ref[f"{arch}/mesh/params/{k}"] for k in rflat0}, rflat0)
    got = rel_l2(updates(flat, rflat0), rm)
    spread = ref[f"{arch}/spread/update"]
    assert got <= FACTOR * spread, (got, spread)
    for name, sh in state["params"].items():
        rep = sh.replica_axes()
        for c, part in sh.parts.items():
            root = list(c)
            for a in rep:
                root[sh.mesh.axis_names.index(a)] = 0
            assert torch.equal(part, sh.parts[tuple(root)]), (name, c)


def check_train_vs_one_device(arch, mesh_shape, ref):
    """The port's mesh step against its one-device step from the same
    weights and batch, within ``FACTOR`` x the reference's (2, 2)
    spread."""
    cfg, model, rparams = ref_model(arch)
    rflat0 = dict(ckpt._flatten(rparams))
    mesh = make_host_mesh(model=mesh_shape[1],
                          shards=mesh_shape[0] * mesh_shape[1], device="cpu")
    m_mesh, _, f_mesh = one_step(cfg, model, mesh)
    _, model, _ = ref_model(arch)
    m_one, _, f_one = one_step(cfg, model)
    for key in _scalars(cfg):
        spread = ref[f"{arch}/spread/{key}"]
        got = abs(float(m_mesh[key]) - float(m_one[key]))
        assert got <= FACTOR * spread, (key, got, spread)
    got = rel_l2(updates(f_mesh, rflat0), updates(f_one, rflat0))
    spread = ref[f"{arch}/spread/update"]
    assert got <= FACTOR * spread, (got, spread)


def check_serving_vs_reference(arch, b, ref):
    """Prefill (bf16 weights, the serving rules; at B = 1 below the data
    axes, ``small_batch``) and one decode step of the reference mesh's
    greedy token on the (2, 2) mesh: the logits agree with the
    reference's mesh logits within ``FACTOR`` x its own
    mesh-vs-unsharded spread (max |diff|); the cache rests as
    ``api.cache_specs`` lays it out."""
    cfg, model, _ = ref_model(arch)
    mesh = mesh22()
    small = b < 2
    max_len = PROMPT + cfg.num_prefix_embeds + GEN_ROOM
    pre = tstep.make_prefill_step(cfg, max_len, mesh=mesh,
                                  small_batch=small)
    dec = tstep.make_serve_step(cfg, mesh=mesh, small_batch=small)
    params = api.shard_params(model, cfg, pre.ctx, dtype=torch.bfloat16)
    batch = to_torch(batch_np(cfg))
    prompt = {k: v[:b] for k, v in batch.items()
              if k in ("patch_embeds", "frames")}
    prompt["tokens"] = batch["tokens"][:b, :PROMPT]
    logits, cache = pre(params, prompt)
    specs = api.cache_specs(cfg, pre.ctx.rules)
    for group in ("kv", "ssm", "enc_kv"):
        for name, sh in cache.get(group, {}).items():
            want = shd.sanitize_spec(specs[group][name], sh.shape, mesh)
            assert sh.spec == want, (group, name, sh.spec, want)
    nxt = torch.from_numpy(ref[f"{arch}/mesh/next{b}"]).long()
    step, _ = dec(params, cache, nxt)
    for name, got in (("prefill", logits), ("decode", step)):
        want = ref[f"{arch}/mesh/{name}{b}"]
        spread = np.abs(want - ref[f"{arch}/one/{name}{b}"]).max()
        err = np.abs(shd.unshard(got).float().numpy() - want).max()
        assert err <= FACTOR * spread, (name, err, spread)
