"""Fault-tolerant training loop, the JAX package's ``train/loop.py``:
checkpoint/restart, exact data resume, straggler detection,
simulated-failure hooks for tests; on one device or on a mesh
(``mesh=``).

Checkpoints are the JAX package's trainer checkpoints
(:func:`save_train_state`), the data pipeline's position in their
``extra``; either package resumes from the other's, on any mesh: a
checkpoint holds logical (unsharded) arrays, a mesh state is unsharded
to save and each leaf sharded from the bytes read to restore.
"""
from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from .. import checkpoint as ckpt
from .. import sharding as shd
from ..convert import lm_flat, lm_tree
from ..configs.base import ModelConfig
from ..kernels.ops import resolve_device
from . import optim
from .step import init_state, make_train_step


def _flat_params(params) -> Dict[str, Any]:
    return dict(params) if isinstance(params, dict) \
        else dict(params.named_parameters())


def _logical(t):
    return shd.unshard(t) if isinstance(t, shd.Sharded) else t.detach()


def train_state_tree(state) -> Dict[str, Any]:
    """A trainer state ``{"params": model, "opt": {"mu", "nu", "step"}}``
    (:func:`repro_torch.train.step.init_state`, on one device or a mesh)
    in the JAX package's layout: keys ``params/layers/attn/wq``,
    ``opt/mu/embed``, ``opt/step`` and so on, the layers stacked on a
    leading L axis, every leaf logical (a mesh state is unsharded)."""
    opt = state["opt"]

    def tree(flat):
        return lm_tree({n: _logical(t) for n, t in flat.items()})

    return {"params": tree(_flat_params(state["params"])),
            "opt": {"mu": tree(opt["mu"]), "nu": tree(opt["nu"]),
                    "step": opt["step"]}}


def save_train_state(ckpt_dir: str, step: int, state,
                     extra: Optional[Dict[str, Any]] = None,
                     keep_n: int = 3) -> str:
    """``checkpoint.save`` of :func:`train_state_tree`: either package
    restores it (the JAX package with ``init_state``'s tree as its
    target)."""
    return ckpt.save(ckpt_dir, step, train_state_tree(state), extra, keep_n)


def restore_train_state(ckpt_dir: str, state, step: Optional[int] = None,
                        verify: bool = False) -> Dict[str, Any]:
    """Restore a trainer checkpoint of either package into ``state`` in
    place (the model's parameters, the moments and ``step``), on the
    state's own layout: the model's device, or, for a mesh state
    (:func:`~repro_torch.train.step.init_state` with ``mesh=``), each
    leaf sharded by its spec from the bytes read
    (``checkpoint.restore(shardings=)``), whatever layout saved it.
    Returns the checkpoint's ``extra``."""
    params = _flat_params(state["params"])

    def shapes(flat):
        return lm_tree({n: torch.empty(t.shape, dtype=t.dtype, device="meta")
                        for n, t in flat.items()})

    def placements(flat):
        # a stacked group's leaf gets its layers' spec behind a layer axis
        return lm_tree({n: shd.Placement(t.mesh, t.spec)
                        for n, t in flat.items()})

    opt = state["opt"]
    target = {"params": shapes(params),
              "opt": {"mu": shapes(opt["mu"]), "nu": shapes(opt["nu"]),
                      "step": opt["step"]}}
    first = next(iter(params.values()))
    sharded = isinstance(first, shd.Sharded)
    shardings = None
    if sharded:
        shardings = {"params": placements(params),
                     "opt": {"mu": placements(opt["mu"]),
                             "nu": placements(opt["nu"]), "step": None}}
        first = next(iter(first.parts.values()))
    tree, extra = ckpt.restore(ckpt_dir, target, step, device=first.device,
                               verify=verify, shardings=shardings)
    with torch.no_grad():
        for name, t in lm_flat(tree["params"]).items():
            if sharded:
                for c, part in params[name].parts.items():
                    part.copy_(t.parts[c])
            else:
                params[name].copy_(t)
    state["opt"] = {"mu": lm_flat(tree["opt"]["mu"]),
                    "nu": lm_flat(tree["opt"]["nu"]),
                    "step": tree["opt"]["step"]}
    return extra


@dataclass
class TrainReport:
    steps_run: int = 0
    final_loss: float = float("nan")
    losses: List[float] = field(default_factory=list)
    step_seconds: List[float] = field(default_factory=list)
    data_seconds: float = 0.0           # in ``data.batch``, apart
    straggler_steps: List[int] = field(default_factory=list)
    resumed_from: Optional[int] = None
    state: Optional[dict] = None        # the final trainer state


def train(
    cfg: ModelConfig,
    data,
    num_steps: int,
    opt_cfg: Optional[optim.AdamWConfig] = None,
    ckpt_dir: Optional[str] = None,
    save_every: int = 100,
    log_every: int = 10,
    seed: int = 0,
    resume: bool = True,
    straggler_factor: float = 3.0,
    fail_at_step: Optional[int] = None,   # test hook: simulated preemption
    log_fn: Callable[[str], None] = print,
    device=None,
    mesh=None,
) -> TrainReport:
    """``device=None`` means ``"cuda"`` and raises without a card.  With a
    ``mesh`` (of that device kind only), the state lives and the steps
    run on it.  A step's seconds run from its batch on the device to its
    loss on the host."""
    dev = resolve_device(device)
    if mesh is not None:
        other = sorted({str(d) for d in mesh.devices.flat
                        if d.type != dev.type})
        if other:
            raise ValueError(f"the mesh names {other} but the trainer runs "
                             f"on {dev.type}")
        dev = shd.device(mesh, shd.coords(mesh)[0])
    opt_cfg = opt_cfg or optim.AdamWConfig(total_steps=num_steps)
    report = TrainReport()

    state = init_state(cfg, seed, dev, mesh=mesh)
    start_step = 0
    if ckpt_dir and resume and ckpt.latest_step(ckpt_dir) is not None:
        extra = restore_train_state(ckpt_dir, state)
        start_step = int(extra["data"]["step"])
        report.resumed_from = start_step
        log_fn(f"[resume] restored step {start_step} from {ckpt_dir}")

    step_fn = make_train_step(cfg, opt_cfg, mesh=mesh)
    durations = report.step_seconds

    for step in range(start_step, num_steps):
        if fail_at_step is not None and step == fail_at_step:
            raise RuntimeError(f"simulated preemption at step {step}")
        t0 = time.perf_counter()
        host = data.batch(step)
        report.data_seconds += time.perf_counter() - t0
        batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        durations.append(dt)
        if len(durations) >= 5:
            med = statistics.median(durations[-50:])
            if dt > straggler_factor * med:
                report.straggler_steps.append(step)
                log_fn(f"[straggler] step {step}: {dt:.3f}s vs median "
                       f"{med:.3f}s")
        report.losses.append(loss)
        report.steps_run += 1
        if log_every and (step + 1) % log_every == 0:
            log_fn(f"step {step+1:5d}  loss {loss:.4f}  "
                   f"gnorm {float(metrics['grad_norm']):.3f}  {dt*1e3:.0f}ms")
        if ckpt_dir and save_every and (step + 1) % save_every == 0:
            save_train_state(ckpt_dir, step + 1, state,
                             extra={"data": data.state(step + 1)})
    # the last step's save, when ``save_every`` made it, is not repeated
    saved_last = (save_every and num_steps > start_step
                  and num_steps % save_every == 0)
    if ckpt_dir and not saved_last:
        save_train_state(ckpt_dir, num_steps, state,
                         extra={"data": data.state(num_steps)})
    report.final_loss = report.losses[-1] if report.losses else float("nan")
    report.state = state
    return report
