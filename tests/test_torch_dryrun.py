"""The port's dry run (``launch/dryrun.py``, ``launch/cost.py``,
``launch/roofline.py``) against the JAX package's, on the CPU.

``repro.launch.dryrun`` forces 512 host devices through ``XLA_FLAGS``
when it is imported; it is imported inside the tests that need it, with
the JAX backend started first and ``XLA_FLAGS`` restored after (so no
later test or subprocess inherits the flag).  Its ``input_specs`` needs
no device (``jax.eval_shape``), and its rules run on a stand-in mesh
object with the production mesh's ``shape``, as ``test_system.py``
does.
"""
import functools
import json
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import ALL_ARCHS, SHAPES, get_config  # noqa: E402
from repro_torch.configs import smoke_variant  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.core.distributed import Mesh  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import cost, dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TINY_MESH = (("data", "model"), [["meta"] * 2] * 2)


def _ref_dryrun():
    """``repro.launch.dryrun`` without its forced device count leaking."""
    jax.devices()                       # the backend starts as it is
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as rdry
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return rdry


@functools.lru_cache(maxsize=None)
def _ref_specs(arch, shape):
    return _ref_dryrun().input_specs(arch, shape)


def _leaves(tree, prefix=()):
    """path -> (shape, dtype name) of every array leaf of a nested dict
    (jax structs or torch tensors); host ints are not leaves."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + (k,)))
        elif hasattr(v, "shape"):
            name = str(v.dtype).replace("torch.", "")
            out[prefix + (k,)] = (tuple(v.shape), name)
    return out


def _port_tree(specs):
    """The port's input specs in the reference's layout: parameter and
    moment dicts stacked into its tree (``convert.lm_tree``)."""
    out = {}
    for k, v in specs.items():
        if k == "state":
            out[k] = {"params": convert.lm_tree(v["params"]), "opt": {
                "mu": convert.lm_tree(v["opt"]["mu"]),
                "nu": convert.lm_tree(v["opt"]["nu"]),
                "step": v["opt"]["step"]}}
        elif k == "params":
            out[k] = convert.lm_tree(v)
        else:
            out[k] = v
    return out


def _len_leaves(leaves):
    """The reference's cache lengths (``len`` leaves): the port keeps the
    filled length as a host int and no per-layer copy."""
    return {p for p in leaves if p[-1] == "len"}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_input_specs_match_reference(arch):
    for shape in SHAPES:
        want = _leaves(jax.tree.map(lambda x: x, _ref_specs(arch, shape)))
        got = _leaves(_port_tree(dryrun.input_specs(arch, shape)))
        extra = set(want) - set(got)
        assert extra == _len_leaves(want), (arch, shape, extra)
        assert set(got) <= set(want), (arch, shape, set(got) - set(want))
        for p in got:
            assert got[p] == want[p], (arch, shape, p)
    specs = dryrun.input_specs(arch, "train_4k")
    assert {t.device.type for t in specs["state"]["params"].values()} == \
        {"meta"}                          # shapes only, nothing drawn


class _FakeMesh:
    def __init__(self, multi_pod):
        self.axis_names = ("pod", "data", "model") if multi_pod \
            else ("data", "model")
        self.shape = dict(zip(self.axis_names,
                              (2, 16, 16) if multi_pod else (16, 16)))


def _ref_resident(arch, shape_name, multi_pod):
    """The sum over the reference's structs of each leaf's shard bytes by
    its own rules and sanitized specs, and the bytes of its ``len``
    leaves."""
    from jax.sharding import PartitionSpec as P
    from repro.configs import SHAPES as RSHAPES, get_config as rget
    from repro.models import api as rapi
    from repro.sharding import make_rules, sanitize_spec_tree, spec
    from repro.train import step as rstep
    mesh = _FakeMesh(multi_pod)
    cfg, shape = rget(arch), RSHAPES[shape_name]
    dp = 32 if multi_pod else 16
    small = shape.global_batch < dp
    specs = _ref_specs(arch, shape_name)
    if shape.kind == "train":
        rules = make_rules(mesh, cfg, small_batch=small)
        spec_tree = {"state": rstep.state_specs(cfg, rules),
                     "batch": rapi.batch_specs(cfg, rules)}
    else:
        rules = make_rules(mesh, cfg, small_batch=small, serving=True)
        spec_tree = {"params": rapi.param_specs(cfg, rules)}
        if shape.kind == "prefill":
            spec_tree["batch"] = rapi.batch_specs(cfg, rules)
        else:
            spec_tree["cache"] = rapi.cache_specs(cfg, rules)
            spec_tree["tokens"] = P(None, None) if small else \
                spec(rules, "batch", None)
    spec_tree = sanitize_spec_tree(spec_tree, specs, mesh)
    total = lens = 0
    flat_specs = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, P))[0]
    structs = dict(jax.tree_util.tree_flatten_with_path(specs)[0])
    for path, sp in flat_specs:
        st = structs[path]
        n = np.dtype(st.dtype).itemsize
        entries = list(sp) + [None] * (len(st.shape) - len(sp))
        for d, e in zip(st.shape, entries):
            axes = () if e is None else (e,) if isinstance(e, str) else e
            k = int(np.prod([mesh.shape[a] for a in axes]))
            n *= d // k
        total += n
        if getattr(path[-1], "key", None) == "len":
            lens += n
    return total, lens


def _ref_rpq_args(multi_pod):
    """The reference's ``lower_rpq`` arguments a device: int8 planes and
    edge arrays split over the data axes, B and PRED replicated."""
    from repro.configs.ring_rpq import CONFIG as c
    shards = 32 if multi_pod else 16
    Vl, El, S = c.num_nodes // shards, c.num_edges // shards, c.nfa_states
    return 2 * Vl * S + 3 * El * 4 + (c.num_labels + 1) * S + S * S


@pytest.mark.parametrize("multi_pod", [False, True])
def test_resident_bytes_match_reference_rules(multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    assert mesh.shape == _FakeMesh(multi_pod).shape
    assert {d.type for d in mesh.devices.flat} == {"meta"}
    for arch in ALL_ARCHS:
        for shape in SHAPES:
            want, lens = _ref_resident(arch, shape, multi_pod)
            got = dryrun.resident(arch, shape, mesh)
            assert got["total"] == want - lens, (arch, shape, got, want)
            assert got["total"] == sum(v for k, v in got.items()
                                       if k != "total")
    rec = dryrun.lower_rpq(mesh)
    assert rec["reference_argument_bytes_per_device"]["total"] == \
        _ref_rpq_args(multi_pod)
    assert rec["config"]["shards"] == (32 if multi_pod else 16)


def test_wire_bytes_match_reference_hlo_model():
    from repro.launch.hlo_analysis import collective_bytes
    lines = {
        "all-gather": ("%a = bf16[32,1024]{1,0} all-gather(bf16[2,1024]{1,0}"
                       " %x), replica_groups=[16,16]<=[256], dimensions={0}",
                       32 * 1024 * 2, 16),
        "all-reduce": ("%b = f32[128]{0} all-reduce(f32[128]{0} %y), "
                       "replica_groups={{0,1,2,3}}, to_apply=%sum",
                       128 * 4, 4),
        "reduce-scatter": ("%c = f32[8,64]{1,0} reduce-scatter(f32[64,64]"
                           "{1,0} %z), replica_groups=[32,8]<=[256], "
                           "dimensions={0}", 8 * 64 * 4, 8),
        "collective-permute": ("%d = f32[64]{0} collective-permute(f32[64]"
                               "{0} %w), source_target_pairs={{0,1}}",
                               64 * 4, 2),
    }
    for kind, (line, size, n) in lines.items():
        want = collective_bytes(line).bytes_by_kind[kind]
        assert cost.wire_bytes(kind, size, n) == pytest.approx(want, rel=0,
                                                               abs=0)
    # the JAX package's test_hlo_collective_parser: its three lines in one
    # module, one collective of each kind, at its stated bytes
    st = collective_bytes("\n".join(lines[k][0] for k in (
        "all-gather", "all-reduce", "collective-permute")))
    assert st.count_by_kind == {"all-gather": 1, "all-reduce": 1,
                                "collective-permute": 1}
    stated = {"all-gather": 32 * 1024 * 2 * 15 / 16,
              "all-reduce": 2 * 128 * 4 * 3 / 4,
              "collective-permute": 64 * 4}
    for kind, value in stated.items():
        _line, size, n = lines[kind]
        assert st.bytes_by_kind[kind] == pytest.approx(value)
        assert cost.wire_bytes(kind, size, n) == pytest.approx(value)
    # the port's names, and the sharding module's own count
    assert cost.wire_bytes("all_gather", 4096, 16) == 4096 * 15 / 16


def test_cost_mode_counts_dots_and_elementwise():
    a = torch.ones(3, 5, 7)
    b = torch.ones(3, 7, 4)
    w = torch.ones(7, 6)
    with cost.CostMode() as mode:
        y = torch.matmul(a, b)            # bmm: 2 * |out| * K
        z = a.reshape(15, 7) @ w           # mm
        (y * 2.0).sum()
    c = mode.counts
    assert c.dot_flops == 2 * (3 * 5 * 4) * 7 + 2 * (15 * 6) * 7
    assert c.flops == c.dot_flops + 3 * 5 * 4 + 3 * 5 * 4
    assert z.shape == (15, 6)
    # the same ops on meta tensors, answered from the cache the second
    # time, count the same
    counts = []
    for _ in range(2):
        with cost.CostMode() as mode:
            for _ in range(2):
                torch.matmul(a.to("meta"), b.to("meta")).exp()
        counts.append((mode.counts.flops, mode.counts.bytes))
    assert counts[0] == counts[1]
    assert counts[0][0] == 2 * (2 * 60 * 7 + 60)


def _tiny(arch):
    base = smoke_variant(get_config(arch))
    if base.family == "hybrid":
        return replace(base, num_layers=5)      # two groups and a tail
    if base.family == "encdec":
        return replace(base, num_layers=4, enc_layers=3)
    return replace(base, num_layers=4)


@pytest.mark.parametrize("arch,shapes", [
    ("smollm-135m", ("train", "prefill", "decode")),
    ("olmoe-1b-7b", ("train",)),
    ("zamba2-7b", ("train", "decode")),
    ("seamless-m4t-medium", ("train", "prefill"))])
def test_extrapolation_equals_full_depth(arch, shapes):
    """dense, moe, hybrid and encdec: the traces at one and two periods,
    extrapolated, equal one trace at full depth in every count."""
    mesh = Mesh(TINY_MESH[1], TINY_MESH[0])
    cfg = _tiny(arch)
    for kind in shapes:
        shape = ShapeSpec(kind, 32, 4, kind)
        ex = dryrun.trace_cell(arch, shape, mesh, cfg=cfg)
        full = dryrun.trace_cell(arch, shape, mesh, cfg=cfg,
                                 full_depth=True)
        assert ex["method"].startswith("extrapolated")
        for k in ("flops", "dot_flops", "bytes", "ops", "saved_bytes",
                  "fwd_all_gather", "fwd_all_reduce", "fwd_reduce_scatter",
                  "bwd_all_gather", "bwd_all_reduce", "bwd_reduce_scatter"):
            assert ex[k] == full[k], (arch, kind, k, ex[k], full[k])
        assert ex["flops"] > 0
        if kind == "train":
            assert ex["saved_bytes"] > 0 and ex["fwd_all_gather"] > 0 and \
                ex["bwd_reduce_scatter"] > 0


def test_meta_trace_counts_the_real_meshs_collectives():
    """The tiny config's train step on a 2 x 2 meta mesh and on a 2 x 2
    CPU mesh with real tensors: the same collective bytes by kind,
    forward and transposed, and the same FLOPs."""
    cfg = replace(_tiny("smollm-135m"), num_layers=2)
    shape = ShapeSpec("t", 32, 4, "train")
    meta = dryrun.trace_step(cfg, shape, Mesh(TINY_MESH[1], TINY_MESH[0]))
    real = dryrun.trace_step(cfg, shape, Mesh([["cpu"] * 2] * 2,
                                              ("data", "model")))
    for k in meta:
        if k.startswith(("fwd_", "bwd_")) or k in ("flops", "dot_flops"):
            assert meta[k] == real[k], (k, meta[k], real[k])


def test_transposes_counted_only_inside_counting_transposes():
    """A collective hooks its outputs for the transposes only while the
    dry run counts: the same gather and backward count nothing outside
    ``counting_transposes`` and the ring model's bytes inside it."""
    from repro_torch import sharding as shd
    mesh = Mesh(["cpu"] * 2, ("data",))

    def gather_and_back():
        parts = {(i,): torch.ones(3, 4, requires_grad=True)
                 for i in range(2)}
        out = shd.all_gather(parts, mesh, ("data",), 0)
        sum(t.sum() for t in out.values()).backward()

    shd.reset_collective_bytes()
    gather_and_back()
    assert shd.collective_bytes()["all_gather"] == 2 * 3 * 4 * 4
    assert shd.transposed_bytes() == {"all_gather": 0, "all_reduce": 0,
                                      "reduce_scatter": 0}
    shd.reset_collective_bytes()
    with shd.counting_transposes():
        gather_and_back()
    assert shd.transposed_bytes()["reduce_scatter"] == 2 * 3 * 4 * 4
    shd.reset_collective_bytes()


def test_ring_rpq_collective_is_the_ports_gather():
    """The ring-rpq record's collective term is the port's all-gather of
    int32 words (4 V_pad W bytes a superstep by the ring model), with
    the reference's int8 planes beside it, not in it."""
    mesh = make_production_mesh()
    rec = dryrun.lower_rpq(mesh)
    c = rec["config"]
    Vp, n, W = c["num_nodes"], c["shards"], (c["nfa_states"] + 31) // 32
    wire = 4 * Vp * W * (n - 1) / n
    gather = rec["gather_bytes_per_superstep"]
    assert gather["port_wire_per_device"] == wire
    assert gather["reference_wire_per_device"] == \
        Vp * c["nfa_states"] * (n - 1) / n
    assert rec["est"]["collective_wire_bytes_per_device"] == \
        c["supersteps"] * wire


@pytest.mark.parametrize("gathered", [False, True])
def test_edge_pass_all_live_is_the_general_count_at_its_most(gathered):
    """``edge_pass_cost`` on an input where every edge, frontier word and
    target is live (every bit below S set, every node a subject and an
    object) equals ``edge_pass_cost_all_live`` less the one term such an
    input cannot reach: a frontier word with every bit set leaves no
    bit to write (4 R V W); a random input stays under the bound."""
    from repro_torch.kernels import packed_superstep as ksup
    R, V, S, L, shards = 2, 24, 16, 5, 2 if gathered else 1
    W, Vg, E = 1, V * shards, 3 * V * shards
    full = (1 << S) - 1
    f = torch.full((R, V, W), full, dtype=torch.int32)
    v = torch.zeros_like(f)
    Bp = torch.full((R, L, W), full, dtype=torch.int32)
    bwd = torch.full((R, S, W), full, dtype=torch.int32)
    subj = torch.arange(E, dtype=torch.int32) % V
    obj = torch.arange(E, dtype=torch.int32) % Vg
    pred = torch.arange(E, dtype=torch.int32) % L
    g = torch.full((R, Vg, W), full, dtype=torch.int32) if gathered \
        else None
    got = ksup.edge_pass_cost(f, v, Bp, bwd, subj, pred, obj, gathered=g)
    most = ksup.edge_pass_cost_all_live(R, V, W, E, L, S,
                                        Vg=Vg if gathered else None)
    assert got == (most[0] - 4 * R * V * W, most[1])
    rng = np.random.default_rng(3)
    rand = [torch.from_numpy(rng.integers(0, full + 1, t.shape)
                             .astype(np.int32)) for t in (f, v, Bp, bwd)]
    gr = None if g is None else torch.from_numpy(
        rng.integers(0, full + 1, g.shape).astype(np.int32))
    some = ksup.edge_pass_cost(*rand, subj, pred, obj, gathered=gr)
    assert some[0] <= most[0] and some[1] <= most[1]


def test_meta_device_named_only():
    assert ops.resolve_device("meta").type == "meta"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ops.resolve_device(None)        # None is cuda, never meta
    m = ops.planes_to_words(torch.zeros((4, 3), dtype=torch.int8)).to("meta")
    with pytest.raises(ValueError, match="meta"):
        ops.nfa_step(m, m)                  # no kernel runs on meta


def test_cli_dryrun_then_roofline(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    art = tmp_path / "art"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm-135m", "--shape", "train_4k", "--out", str(art)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads((art / "smollm-135m__train_4k__pod1.json").read_text())
    assert rec["ok"] and rec["num_devices"] == 256
    assert rec["method"].startswith("extrapolated")
    assert rec["fits_h100"] and rec["flops_per_device"] > 0
    assert rec["collectives"]["bytes_by_kind"]["reduce-scatter"] > 0
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.roofline", "--art",
         str(art), "--out", str(tmp_path / "roof")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    rows = json.loads((tmp_path / "roof" / "roofline.json").read_text())
    assert len(rows) == 1 and rows[0]["dominant"] in (
        "compute", "memory", "collective")
    assert "H100" in out.stdout
