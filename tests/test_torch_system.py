"""The JAX package's ``tests/test_system.py`` on the port, each test under
its own name: every engine agrees on a workload, held to the reference's
answers; the path LM learns on the CPU; the dry run's input specs; and
the port's dry-run sweep, where it has been run.  The reference file's
two other tests have counterparts by another name
(``tests/test_torch_hygiene.py`` ``COUNTERPART_EXCEPTIONS``)."""
import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.fixtures import random_graph  # noqa: E402
from torch_parity import both  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _engines_agree(P, g):
    """The reference test's body on one package: the ring, the ring with
    the paper's literal D[v] rule and the dense engine on a 25-query
    workload.  Returns every answer."""
    ring_eng = P.RingRPQ(P.Ring(g))
    paper_eng = P.RingRPQ(P.Ring(g), paper_dv=True)
    dense_eng = P.DenseRPQ(g)
    wl = P.generate_workload(25, num_preds=4, num_nodes=30, seed=9)
    out = []
    for expr, s, o, pat in wl.queries:
        r1 = ring_eng.eval(expr, subject=s, obj=o)
        r2 = dense_eng.eval(expr, subject=s, obj=o)
        r3 = paper_eng.eval(expr, subject=s, obj=o)
        assert r1 == r2, (expr, s, o, pat)
        # the literal paper D[v] rule may under-report (see
        # test_core.test_paper_dv_rule_overprunes) but never over-reports
        assert r3 <= r1, (expr, s, o, pat)
        out.append((expr, s, o, pat, r1, r3))
    return out


def test_all_engines_agree_end_to_end():
    """On both packages (``torch_parity.both``): the reference's asserts
    on each, and every answer of the port equal to the reference's
    (exact)."""
    both(_engines_agree, random_graph(30, 4, 120, seed=42))


def test_path_lm_end_to_end_learns():
    """The paper-integration path LM on the CPU: a 2-layer LM trained 40
    steps on RPQ-sampled metro paths; the mean of the last 5 losses is
    more than 0.5 below the mean of the first 3 (the reference's
    bound)."""
    from dataclasses import replace

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.core.fixtures import metro_graph
    from repro_torch.data.pipeline import PathCorpus
    from repro_torch.train import loop, optim
    g = metro_graph()
    pc = PathCorpus(g, seq_len=24, global_batch=8, expr="(l1|l2|l5)+", seed=0)
    cfg = replace(smoke_variant(get_config("smollm-135m")),
                  vocab_size=pc.vocab_size, num_layers=2, d_model=32,
                  num_heads=2, num_kv_heads=1, head_dim=16, d_ff=64)
    rep = loop.train(cfg, pc, num_steps=40, log_every=0, save_every=0,
                     opt_cfg=optim.AdamWConfig(lr=5e-3, warmup_steps=5,
                                               total_steps=40),
                     log_fn=lambda s: None, device="cpu")
    assert len(rep.losses) == 40
    assert np.mean(rep.losses[-5:]) < np.mean(rep.losses[:3]) - 0.5


def test_dryrun_machinery_on_host_mesh():
    """``dryrun.input_specs`` gives the reference test's shapes, on the
    meta device (nothing drawn)."""
    from repro_torch.launch import dryrun
    specs = dryrun.input_specs("smollm-135m", "train_4k")
    assert tuple(specs["batch"]["tokens"].shape) == (256, 4096)
    assert specs["batch"]["tokens"].device.type == "meta"
    specs = dryrun.input_specs("mamba2-2.7b", "long_500k")
    assert tuple(specs["tokens"].shape) == (1, 1)
    assert "ssm" in specs["cache"]


def test_sweep_artifacts_complete_if_present():
    """If the port's sweep has been run (``python -m
    repro_torch.launch.dryrun --all --both-meshes``, into
    ``artifacts/dryrun_torch/``), every (arch x shape x mesh) cell is
    accounted for: ok or a documented skip; a failure is a bug.  Skips,
    as the reference does, where the sweep has not been run."""
    from repro_torch.configs import ALL_ARCHS, SHAPES
    from repro_torch.launch.dryrun import ART
    art = os.path.join(ROOT, ART)
    if not os.path.isdir(art) or not os.listdir(art):
        pytest.skip("sweep not run in this environment")
    missing, failed = [], []
    for mp in ("pod1", "pod2"):
        for a in ALL_ARCHS:
            for s in SHAPES:
                p = os.path.join(art, f"{a}__{s}__{mp}.json")
                if not os.path.exists(p):
                    missing.append((a, s, mp))
                    continue
                with open(p) as f:
                    rec = json.load(f)
                if not (rec.get("ok") or rec.get("skipped")):
                    failed.append((a, s, mp, rec.get("error")))
    assert not missing, missing
    assert not failed, failed
