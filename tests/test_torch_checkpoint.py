"""The port's checkpointing (``repro_torch.checkpoint``) on the CPU: the
JAX package's checkpoint tests on the port, the stats and mid-overlay
resumes, checkpoints crossing between the packages in both directions,
restores onto a different mesh, and its msgpack codec held to
``msgpack`` byte for byte.  Exact everywhere."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import checkpoint as rckpt  # noqa: E402
from repro.core import fixtures as rfix  # noqa: E402
from repro.core.engines import make_engine as rmake  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import regex as rx  # noqa: E402
from repro_torch.core.distributed import Mesh  # noqa: E402
from repro_torch.core.engines import make_engine  # noqa: E402
from repro_torch.core.oracle import eval_oracle  # noqa: E402
from repro_torch.core.ring import Ring  # noqa: E402
from repro_torch.core.rpq import QueryStats, RingRPQ  # noqa: E402
from repro_torch.core.stats import GraphStats  # noqa: E402

EXPRS = ("0/1*", "2+", "^1/0*")


def _restore(path, target, **kw):
    return ckpt.restore(str(path), target, device="cpu", **kw)


# -- the JAX package's checkpoint tests (tests/test_substrate.py), on the port --

def test_checkpoint_roundtrip(tmp_path):
    state = {"a": torch.arange(10, dtype=torch.float32),
             "nested": {"b": torch.ones((3, 4), dtype=torch.bfloat16)},
             "step": np.int32(7), "rows": [np.zeros((0, 3), np.int64),
                                           torch.tensor(5, dtype=torch.uint8)]}
    ckpt.save(str(tmp_path), 7, state, extra={"data": {"step": 7}})
    restored, extra = _restore(tmp_path, state, verify=True)
    assert extra["data"]["step"] == 7
    assert torch.equal(restored["a"], state["a"])
    assert restored["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(restored["nested"]["b"], state["nested"]["b"])
    assert restored["step"].dtype == torch.int32 and int(restored["step"]) == 7
    assert restored["rows"][0].shape == (0, 3)
    assert restored["rows"][1].dtype == torch.uint8


def test_checkpoint_retention_and_latest(tmp_path):
    state = {"x": torch.zeros(3)}
    for s in [10, 20, 30, 40, 50]:
        ckpt.save(str(tmp_path), s, state, keep_n=3)
    assert ckpt.all_steps(str(tmp_path)) == [30, 40, 50]
    assert ckpt.latest_step(str(tmp_path)) == 50
    assert ckpt.all_steps(str(tmp_path / "none")) == []
    with pytest.raises(FileNotFoundError):
        _restore(tmp_path / "none", state)


def test_checkpoint_atomicity(tmp_path):
    """A checkpoint without a manifest (a write cut off) is invisible."""
    state = {"x": torch.zeros(3)}
    ckpt.save(str(tmp_path), 1, state)
    broken = tmp_path / "step_0000000002"
    broken.mkdir()
    (broken / "arrays.msgpack.zst").write_bytes(b"garbage")
    assert ckpt.latest_step(str(tmp_path)) == 1
    restored, _ = _restore(tmp_path, state)
    assert torch.equal(restored["x"], state["x"])


def test_checkpoint_codec_recorded_and_zlib_roundtrip(tmp_path):
    state = {"x": torch.arange(5, dtype=torch.float32)}
    path = ckpt.save(str(tmp_path), 1, state, codec="zlib")
    manifest = json.loads((Path(path) / "manifest.json").read_text())
    assert manifest["codec"] == "zlib"
    restored, _ = _restore(tmp_path, state, verify=True)
    assert torch.equal(restored["x"], state["x"])
    # the port's default codec is zlib, importable everywhere
    ckpt.save(str(tmp_path), 2, state)
    m2 = json.loads((tmp_path / "step_0000000002" / "manifest.json")
                    .read_text())
    assert m2["codec"] == ckpt.DEFAULT_CODEC == "zlib"
    with pytest.raises(ValueError, match="codec"):
        ckpt.save(str(tmp_path), 3, state, codec="lz4")


def test_checkpoint_zstd_read_and_missing_zstandard(tmp_path, monkeypatch):
    """A zstd checkpoint reads through ``zstandard`` when it is installed,
    and raises a clear error when it is not."""
    state = {"x": np.arange(6, dtype=np.int64)}
    pytest.importorskip("zstandard")
    rckpt.save(str(tmp_path), 1, state, codec="zstd")
    restored, _ = _restore(tmp_path, state, verify=True)
    assert restored["x"].tolist() == list(range(6))
    monkeypatch.setitem(sys.modules, "zstandard", None)
    with pytest.raises(RuntimeError, match="zstandard is not installed"):
        _restore(tmp_path, state)


def test_checkpoint_shape_mismatch_detected(tmp_path):
    ckpt.save(str(tmp_path), 1, {"x": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        _restore(tmp_path, {"x": torch.zeros(4)})
    with pytest.raises(KeyError, match="missing"):
        _restore(tmp_path, {"y": torch.zeros(3)})


def test_checkpoint_verify_detects_corruption(tmp_path):
    """``verify=True`` checks every array's sha256 against the manifest."""
    state = {"x": torch.arange(8, dtype=torch.int64)}
    path = Path(ckpt.save(str(tmp_path), 1, state))
    manifest = json.loads((path / "manifest.json").read_text())
    manifest["arrays"]["x"]["sha256"] = "0" * 64
    (path / "manifest.json").write_text(json.dumps(manifest))
    _restore(tmp_path, state)                      # unverified: loads
    with pytest.raises(IOError, match="checksum"):
        _restore(tmp_path, state, verify=True)


# -- engine state -----------------------------------------------------------------

def test_graph_stats_checkpoint_roundtrip(tmp_path):
    """``tests/test_planner.py:116`` on the port: stats ride a checkpoint
    and a restored engine plans without rescanning the graph."""
    g = convert.graph_from_reference(rfix.random_graph(25, 3, 90, seed=5))
    ring = Ring(g)
    stats = GraphStats.from_ring(ring)
    ckpt.save(str(tmp_path), 7, stats.to_state())
    restored_state, _ = _restore(tmp_path, stats.to_state())
    assert isinstance(restored_state["freq"], torch.Tensor)
    restored = GraphStats.from_state(restored_state)
    assert restored.num_nodes == stats.num_nodes
    assert restored.num_edges == stats.num_edges
    assert np.array_equal(restored.freq, stats.freq)
    assert np.array_equal(restored.distinct_subj, stats.distinct_subj)
    assert np.array_equal(restored.distinct_obj, stats.distinct_obj)
    fresh = RingRPQ(ring, device="cpu")
    injected = RingRPQ(ring, device="cpu", stats=restored)
    for expr, sub, ob in [("0/1", None, None), ("0*/2", None, 3),
                          ("1/0*", 2, 5)]:
        ast = rx.parse(expr)
        a = fresh._decide(ast, sub is not None, ob is not None, QueryStats())
        b = injected._decide(ast, sub is not None, ob is not None,
                             QueryStats())
        assert (a.mode, a.split_pred) == (b.mode, b.split_pred)
    assert injected._stats is restored


def _mutated_source(g):
    src = make_engine(g, "ring", device="cpu")
    src.add_edges([(1, 0, 3), (5, 1, 1), (2, 2, 9)])
    src.remove_edges([(int(g.s[0]), int(g.p[0]), int(g.o[0]))])
    return src, {e: src.eval(e) for e in EXPRS}


@pytest.mark.parametrize("kind", ["ring", "dense"])
def test_updates_checkpoint_resume_mid_overlay(tmp_path, kind):
    """``tests/test_updates.py:219`` on the port: a restored engine
    resumes at the same epoch with the same pending deltas, keeps
    answering exactly, and keeps accepting mutations."""
    g = convert.graph_from_reference(
        rfix.random_graph(12, 3, 30, seed=4, pred_zipf=False))
    src, want = _mutated_source(g)
    state = {"overlay": src.overlay_state(),
             "stats": src.graph_stats.to_state()}
    ckpt.save(str(tmp_path), 7, state)
    restored, _ = _restore(tmp_path, state)
    eng = make_engine(g, kind, device="cpu")
    eng.load_overlay(restored["overlay"])
    assert eng.epoch == src.epoch == 2
    for e, w in want.items():
        assert eng.eval(e) == w, (kind, e)
    eng.add_edges([(0, 1, 7)])
    assert eng.epoch == 3
    assert eng.eval("1") == eval_oracle(eng.effective_graph(), "1")


@pytest.mark.parametrize("codec", ["zlib", "zstd"])
def test_reference_checkpoint_restores_in_port(tmp_path, codec):
    """The JAX package saves an engine's stats and overlay; the port
    restores them: equal arrays and manifest keys, and a port engine that
    loads them answers as the reference's source engine."""
    if codec == "zstd":
        pytest.importorskip("zstandard")
    g = rfix.random_graph(12, 3, 30, seed=4, pred_zipf=False)
    src = rmake(g, "ring")
    src.add_edges([(1, 0, 3), (5, 1, 1)])
    src.remove_edges([(int(g.s[0]), int(g.p[0]), int(g.o[0]))])
    state = {"overlay": src.overlay_state(),
             "stats": src.graph_stats.to_state()}
    path = Path(rckpt.save(str(tmp_path), 3, state, extra={"k": 1},
                           codec=codec))
    got, extra = _restore(tmp_path, state, verify=True)
    assert extra == {"k": 1}
    manifest = json.loads((path / "manifest.json").read_text())
    assert sorted(manifest["arrays"]) == sorted(
        f"{a}/{b}" for a in state for b in state[a])
    for a in state:
        for b, arr in state[a].items():
            np.testing.assert_array_equal(got[a][b].numpy(), np.asarray(arr))
            assert str(got[a][b].dtype) == f"torch.{np.asarray(arr).dtype}"
    eng = make_engine(convert.graph_from_reference(g), "dense", device="cpu",
                      stats=GraphStats.from_state(got["stats"]))
    eng.load_overlay(got["overlay"])
    assert eng.epoch == src.epoch
    for e in EXPRS:
        assert eng.eval(e) == src.eval(e), e


def test_port_checkpoint_restores_in_reference(tmp_path):
    """The port saves (tensors and numpy leaves); the JAX package
    restores: equal arrays, the same manifest keys and hashes as its own
    save of the same state, and the same msgpack payload."""
    g = convert.graph_from_reference(
        rfix.random_graph(12, 3, 30, seed=4, pred_zipf=False))
    src, want = _mutated_source(g)
    state = {"overlay": src.overlay_state(),
             "stats": {k: torch.as_tensor(v) for k, v in
                       src.graph_stats.to_state().items()}}
    host = {a: {b: np.asarray(v) for b, v in d.items()}
            for a, d in state.items()}
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    p = Path(ckpt.save(str(port_dir), 5, state, codec="zlib"))
    r = Path(rckpt.save(str(ref_dir), 5, host, codec="zlib"))
    mp, mr = (json.loads((d / "manifest.json").read_text()) for d in (p, r))
    assert mp["arrays"] == mr["arrays"]
    assert (p / "arrays.msgpack.zst").read_bytes() == \
        (r / "arrays.msgpack.zst").read_bytes()
    restored, _ = rckpt.restore(str(port_dir), host, verify=True)
    for a in host:
        for b, arr in host[a].items():
            np.testing.assert_array_equal(np.asarray(restored[a][b]), arr)
    from repro.core.stats import GraphStats as RStats
    rs = RStats.from_state(restored["stats"])
    assert np.array_equal(rs.freq, src.graph_stats.freq)
    ref = rmake(rfix.random_graph(12, 3, 30, seed=4, pred_zipf=False), "ring")
    ref.load_overlay({k: np.asarray(v) for k, v in
                      restored["overlay"].items()})
    assert ref.epoch == src.epoch
    for e, w in want.items():
        assert ref.eval(e) == w, e


@pytest.mark.parametrize("kind", ["ring", "dense"])
def test_elastic_restore_across_meshes(tmp_path, kind):
    """Save from an unsharded engine and restore into one sharded 3 ways,
    then save from that one and restore unsharded: answers stay equal to
    the source's and the oracle's."""
    g = convert.graph_from_reference(
        rfix.random_graph(20, 3, 60, seed=6, pred_zipf=False))
    kw = {"kernel_threshold": 1} if kind == "ring" else {}
    src = make_engine(g, kind, device="cpu", **kw)
    src.add_edges([(1, 0, 3), (5, 1, 1), (2, 2, 9)])
    src.remove_edges([(int(g.s[1]), int(g.p[1]), int(g.o[1]))])
    want = {e: src.eval(e, obj=3) for e in EXPRS}
    mesh = Mesh(["cpu"] * 3, ("data",))

    def roundtrip(eng, step, **knobs):
        state = {"overlay": eng.overlay_state(),
                 "stats": eng.graph_stats.to_state()}
        ckpt.save(str(tmp_path), step, state)
        got, _ = _restore(tmp_path, state, verify=True)
        out = make_engine(g, kind, device="cpu",
                          stats=GraphStats.from_state(got["stats"]),
                          **knobs, **kw)
        out.load_overlay(got["overlay"])
        assert out.epoch == src.epoch
        for e, w in want.items():
            assert out.eval(e, obj=3) == w == eval_oracle(
                out.effective_graph(), e, None, 3), (kind, e)
        return out

    sharded = roundtrip(src, 1, mesh=mesh)
    if kind == "dense":
        assert sharded.sharded.num_shards == 3 and \
            sharded.sharded.dispatches > 0
    else:
        assert sharded._num_shards == 3 and sharded.sharded_kernel_batches
    back = roundtrip(sharded, 2)
    assert (back.mesh if kind == "ring" else back.sharded) is None


# -- the codec ------------------------------------------------------------------

PAYLOADS = [
    {},
    {"a": b"x"},
    {f"key{i}": bytes(range(i % 256)) * (1 + i) for i in range(40)},
    {"k" * 31: b"", "k" * 32: b"\0" * 255, "k" * 300: b"\1" * 256},
    {"big": bytes(70_000), "huge_key_" + "z" * 70_000: b"v"},
]


@pytest.mark.parametrize("i", range(len(PAYLOADS)))
def test_msgpack_codec_matches_msgpack(i):
    msgpack = pytest.importorskip("msgpack")
    payload = PAYLOADS[i]
    blob = ckpt.packb(payload)
    assert blob == msgpack.packb(payload, use_bin_type=True)
    assert ckpt.unpackb(blob) == payload
    assert msgpack.unpackb(blob, raw=False) == payload
    with pytest.raises(ValueError):
        ckpt.unpackb(blob + b"\0")
