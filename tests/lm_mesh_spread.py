"""How far an LM's (data 2, model 2) mesh run sits from its unsharded run
in each package, at a stand-in size on the CPU: step 1's gradient
(relative L2, whole and worst leaf) and the losses of a few AdamW steps,
in the JAX package (a subprocess with four forced host devices) and in
the port (four repeats of the host).  ``chip_smoke.py`` takes its mesh
gates for the mamba families from these spreads: a mamba layer's decay
``exp(dt * A)`` moves by ``|dt * A|`` times a relative change of its
input, so a stack of them amplifies the bf16 rounding that a mesh moves,
in both packages alike.

    PYTHONPATH=src python tests/lm_mesh_spread.py zamba2-7b:7 mamba2-2.7b:2

prints one JSON line a config (``arch:num_layers[:attn_period]``) and
package.  ``--same-weights``: the port starts from the reference's
seed-0 parameters (each package's own draw by default), and a third
line gives the step-1 gradient of each side against the other
package's one-device gradient.  ``--dt-init``: ``dt_bias`` set by
Mamba2's published init (``dt`` log-spaced over [1e-3, 1e-1] across the
heads; the reference's init is 0, so ``dt`` is about 0.7) in both
packages; with it, the losses are not run.  The stand-in keeps the
family's structure and cuts its widths (``STAND_IN``: d_model 512, 4
heads of 128, d_ff 1,024, vocab 32,000, SSM state 64, head dim 64, two
SSD chunks of 256 at T = 512, B = 4); the batches are ``SyntheticLM``'s,
the optimizer phase 12 (c)'s (lr 3e-4 warmed up over the 5 steps)."""
import json
import os
import subprocess
import sys
import textwrap
from dataclasses import replace
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
STAND_IN = dict(d_model=512, num_heads=4, num_kv_heads=4, head_dim=128,
                d_ff=1024, vocab_size=32000, ssm_state=64, ssm_headdim=64,
                tp_divisor=1)
B, T, STEPS = 4, 512, 5

REFERENCE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    from dataclasses import replace
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import get_config
    from repro.data.pipeline import SyntheticLM
    from repro.models import api
    from repro.models.common import ShardCtx
    from repro.sharding import make_rules, sanitize_spec_tree
    from repro.train import optim, step as tstep
    arch, layers = sys.argv[1], int(sys.argv[2])
    stand_in, B, T, steps = json.loads(sys.argv[3]), {B}, {T}, {STEPS}
    save, dt_bias = sys.argv[4], json.loads(sys.argv[5])
    cfg = replace(get_config(arch), num_layers=layers, **stand_in)
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    rules = make_rules(mesh, cfg)
    data = SyntheticLM(cfg.vocab_size, T, B)
    batch = lambda s: {{k: jnp.asarray(v) for k, v in data.batch(s).items()}}
    state = tstep.init_state(cfg, jax.random.PRNGKey(0))
    if dt_bias is not None:
        m = state["params"]["layers"]["mamba"]
        m["dt_bias"] = jnp.broadcast_to(jnp.asarray(dt_bias, jnp.float32),
                                        m["dt_bias"].shape)
    specs = sanitize_spec_tree(tstep.state_specs(cfg, rules),
                               jax.eval_shape(lambda: state), mesh)
    placed = jax.device_put(state, jax.tree.map(
        lambda s: NamedSharding(mesh, s), specs,
        is_leaf=lambda x: isinstance(x, P)))
    def flat(tree, pre):
        return {{pre + "/".join(str(getattr(p, "key", p)) for p in path):
                np.asarray(x, np.float32) for path, x in
                jax.tree_util.tree_flatten_with_path(tree)[0]}}
    out, losses = flat(state["params"], "w/"), {{}}
    for name, ctx, st in (("one", ShardCtx(), state),
                          ("mesh", ShardCtx(mesh, rules), placed)):
        g = jax.jit(jax.grad(lambda p: api.loss_fn(p, batch(0), cfg,
                                                    ctx)[0]))(st["params"])
        out.update(flat(g, name + "/"))
        if dt_bias is not None:
            continue
        fn = jax.jit(tstep.make_train_step(cfg, optim.AdamWConfig(
            lr=3e-4, warmup_steps=steps, total_steps=steps),
            None if name == "one" else mesh))
        losses[name] = []
        for s in range(steps):
            st, m = fn(st, batch(s))
            losses[name].append(float(m["loss"]))
    np.savez(save, **out)
    print("RESULT " + json.dumps({{"losses": losses}}))
""").format(B=B, T=T, STEPS=STEPS)


def _cfg(arch: str, layers: int, period):
    from repro_torch.configs import get_config
    extra = {} if period is None else {"attn_period": period}
    return replace(get_config(arch), num_layers=layers, **STAND_IN, **extra)


def mamba2_dt_bias(heads: int) -> list:
    """Mamba2's published ``dt`` init (log-uniform over [1e-3, 1e-1]),
    log-spaced across the heads, as the bias ``softplus`` maps to it."""
    dt = np.geomspace(1e-3, 1e-1, heads)
    return (dt + np.log(-np.expm1(-dt))).tolist()


def spread(one: dict, mesh: dict, losses) -> dict:
    """The mesh's step-1 gradient against one device's (name -> f64
    array), relative L2, whole and worst leaf, and the largest loss
    difference over the steps."""
    num = sum(float(((mesh[k] - one[k]) ** 2).sum()) for k in one)
    den = sum(float((one[k] ** 2).sum()) for k in one)
    leaf = max((float(np.linalg.norm(mesh[k] - one[k])
                      / max(np.linalg.norm(one[k]), 1e-30)), k) for k in one)
    out = {"grad_rel_l2": (num / den) ** 0.5,
           "grad_rel_l2_max_leaf": leaf[0], "worst_leaf": leaf[1]}
    if losses:
        out.update({"losses": losses, "losses_max_diff": max(
            abs(a - b) for a, b in zip(losses["one"], losses["mesh"]))})
    return out


def reference(arch: str, layers: int, period, save: Path, dt_bias):
    """The reference's one-device and mesh gradients (by its tree's
    paths), its seed-0 parameters and losses."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    stand_in = {**STAND_IN, **({} if period is None
                               else {"attn_period": period})}
    r = subprocess.run([sys.executable, "-c", REFERENCE, arch, str(layers),
                        json.dumps(stand_in), str(save),
                        json.dumps(dt_bias)], env=env, cwd=ROOT,
                       capture_output=True, text=True, check=True)
    losses = json.loads(r.stdout.split("RESULT ", 1)[1])["losses"]
    z = np.load(save)
    part = {p: {k[len(p) + 1:]: z[k].astype(np.float64) for k in z.files
                if k.startswith(p + "/")} for p in ("w", "one", "mesh")}
    return part, losses


def _nest(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        *path, leaf = k.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def port(cfg, weights, dt_bias, steps: int) -> tuple:
    """The port's one-device and mesh gradients (by the reference tree's
    paths) and losses, from ``weights`` (the reference's parameter
    tree) or its own seed-0 draw."""
    import torch
    from repro_torch import convert
    from repro_torch import sharding as shd
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api
    from repro_torch.models.common import ShardCtx
    from repro_torch.train import optim
    from repro_torch.train import step as tstep
    mesh = make_host_mesh(model=2, shards=4, device="cpu")
    data = SyntheticLM(cfg.vocab_size, T, B)

    def batch(s):
        return {k: torch.from_numpy(v) for k, v in data.batch(s).items()}

    model = api.init_params(cfg, 0, "cpu")
    with torch.no_grad():
        if weights is not None:
            model.load_state_dict(convert.lm_params_from_reference(weights))
        if dt_bias is not None:
            for n, t in model.named_parameters():
                if n.endswith("dt_bias"):
                    t.copy_(torch.tensor(dt_bias))
    grads, losses = {}, {}
    for name, m in (("one", None), ("mesh", mesh)):
        state = tstep.init_state(cfg, 0, "cpu", mesh=m)
        if m is None:
            state["params"].load_state_dict(model.state_dict())
            params = state["params"]
            named = dict(params.named_parameters())
            loss, _ = api.loss_fn(params, batch(0), cfg)
            g = dict(zip(named, torch.autograd.grad(loss,
                                                    list(named.values()))))
        else:
            ctx = ShardCtx(m, shd.make_rules(m, cfg))
            params = state["params"] = api.shard_params(
                model, cfg, ctx, requires_grad=True)
            state["opt"] = optim.init(params)
            loss, _ = api.loss_fn(params, batch(0), cfg, ctx)
            g = {n: shd.unshard(x) for n, x in
                 tstep.mesh_grads(params, loss).items()}
        tree = convert.lm_params_to_reference(
            {n: x.detach() for n, x in g.items()})
        grads[name] = {"/".join(p): np.asarray(v, np.float64)
                       for p, v in _paths(tree)}
        if not steps:
            continue
        fn = tstep.make_train_step(cfg, optim.AdamWConfig(
            lr=3e-4, warmup_steps=steps, total_steps=steps), mesh=m)
        losses[name] = []
        for s in range(steps):
            state, metrics = fn(state, batch(s))
            losses[name].append(float(metrics["loss"]))
    return grads, losses


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def main(argv) -> int:
    import tempfile
    same = "--same-weights" in argv
    dt_init = "--dt-init" in argv
    steps = 0 if dt_init else STEPS
    for item in (a for a in argv if not a.startswith("--")):
        arch, layers, *period = item.split(":")
        period = int(period[0]) if period else None
        cfg = _cfg(arch, int(layers), period)
        dt_bias = mamba2_dt_bias(cfg.ssm_heads) if dt_init else None
        head = {"arch": arch, "num_layers": int(layers),
                "attn_period": cfg.attn_period, "stand_in": STAND_IN,
                "batch": B, "seq": T, "same_weights": same,
                "dt_init": dt_init}
        with tempfile.TemporaryDirectory() as d:
            ref, rlosses = reference(arch, int(layers), period,
                                     Path(d) / "ref.npz", dt_bias)
        print(json.dumps({**head, "package": "reference",
                          **spread(ref["one"], ref["mesh"], rlosses)}),
              flush=True)
        got, plosses = port(cfg, _nest(ref["w"]) if same else None,
                            dt_bias, steps)
        print(json.dumps({**head, "package": "port",
                          **spread(got["one"], got["mesh"], plosses)}),
              flush=True)
        if same:
            print(json.dumps({**head, "package": "across", **{
                f"{b}_{sa}_vs_{a}_one": spread(x["one"], y[sa], None)
                ["grad_rel_l2"] for a, x, b, y in (
                    ("reference", ref, "port", got),
                    ("port", got, "reference", ref))
                for sa in ("one", "mesh")}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
