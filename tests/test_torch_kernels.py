"""The port's kernels against the JAX package's, bit for bit.

On the CPU the port's entry points run their plain PyTorch versions; the
JAX side runs the Pallas kernels in interpret mode (as
``tests/test_kernels.py`` does) and its pure-jnp oracles.  The CUDA
kernels themselves are held to the plain versions in
``test_torch_cuda.py``, which runs only on a machine with a card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_compat import given, settings, strategies as st

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.kernels.nfa_step import pack_block_diagonal as j_pack  # noqa: E402
from repro.kernels.segment_or import (  # noqa: E402
    TILE_E as J_TILE_E, segmented_or_scan as j_scan_tiles)
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.kernels import ops as tops, ref as tref  # noqa: E402
from repro.core.dense import DenseGraph as JDenseGraph  # noqa: E402
from repro.core.fixtures import random_graph  # noqa: E402
from repro_torch.kernels import nfa_step as tnfa  # noqa: E402
from repro_torch.kernels import packed_superstep as tsup  # noqa: E402
from repro_torch.kernels import rank_popcount as trank  # noqa: E402
from repro_torch.kernels import segment_or as tseg  # noqa: E402

SWEEP = [(1, 1), (5, 4), (700, 33), (1024, 64), (513, 32), (2048, 7)]


def _mask_tail(arr, S):
    if S % 32:
        arr[..., (S - 1) // 32] &= np.uint32((1 << (S % 32)) - 1)
    return arr


def _inputs(rng, N, S, W=None):
    W = W or (S + 31) // 32
    X = _mask_tail(rng.integers(0, 2**32, (N, W), dtype=np.uint32), S)
    bwd = _mask_tail(rng.integers(0, 2**32, (S, W), dtype=np.uint32), S)
    return X, bwd


def _port_nfa_step(X, bwd):
    Y = tops.nfa_step(tops.words_to_tensor(X, "cpu"),
                      tops.words_to_tensor(bwd, "cpu"))
    assert Y.dtype == torch.int32 and Y.device.type == "cpu"
    return tops.tensor_to_words(Y)


def _assert_all_agree(X, bwd):
    got = _port_nfa_step(X, bwd)
    pallas = np.asarray(jops.nfa_step(X, bwd))
    oracle = np.asarray(jref.nfa_step_ref(jnp.asarray(X), jnp.asarray(bwd)))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, oracle)


@pytest.mark.parametrize("N,S", SWEEP)
def test_nfa_step_shapes(N, S):
    X, bwd = _inputs(np.random.default_rng(N * 1000 + S), N, S)
    _assert_all_agree(X, bwd)


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 300), st.integers(1, 48), st.integers(0, 2**31 - 1))
def test_nfa_step_property(N, S, seed):
    X, bwd = _inputs(np.random.default_rng(seed), N, S)
    _assert_all_agree(X, bwd)


@pytest.mark.parametrize("N,S,W", [(37, 70, 4), (9, 65, 3), (50, 40, 4),
                                   (64, 33, 3)])
def test_nfa_step_wide_and_padded_words(N, S, W):
    """W > 1, and tables narrower than their words (S < 32 W, as in a
    pow2-padded bundle): bits of X at or above S select nothing."""
    rng = np.random.default_rng(S * 31 + W)
    X = rng.integers(0, 2**32, (N, W), dtype=np.uint32)   # bits >= S set
    bwd = _mask_tail(rng.integers(0, 2**32, (S, W), dtype=np.uint32), S)
    _assert_all_agree(X, bwd)


def test_word_crossing_keeps_bits():
    words = np.array([[0, 1, 0x7FFFFFFF], [0x80000000, 0xFFFFFFFF, 5]],
                     dtype=np.uint32)
    t = tops.words_to_tensor(words, "cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(tops.tensor_to_words(t), words)
    np.testing.assert_array_equal(
        tops.tensor_to_words(tref.narrow(tref.widen(t))), words)


def test_pack_unpack_match_reference():
    rng = np.random.default_rng(3)
    for shape in [(17, 45), (3, 5, 64), (1, 1), (8, 33)]:
        planes = rng.integers(0, 2, shape).astype(np.uint8)
        packed = tops.pack_bits(planes)
        assert packed.shape == (*shape[:-1], (shape[-1] + 31) // 32)
        np.testing.assert_array_equal(packed, jops.pack_bits(planes))
        np.testing.assert_array_equal(tops.unpack_bits(packed, shape[-1]),
                                      jops.unpack_bits(packed, shape[-1]))
        np.testing.assert_array_equal(
            tops.unpack_bits(packed, shape[-1]), planes)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_block_diagonal_matches_reference(seed):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 40, rng.integers(1, 6)).tolist()
    masks = [[int(rng.integers(0, 2**min(s, 62))) for _ in range(s)]
             for s in sizes]
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).tolist()
    total = int(sum(sizes)) + int(rng.integers(0, 40))   # padded, as pow2
    got = tnfa.pack_block_diagonal(masks, offsets, total)
    np.testing.assert_array_equal(got, j_pack(masks, offsets, total))
    # and the bundle steps like each plan alone through the port kernel
    X, _ = _inputs(rng, 20, total)
    _assert_all_agree(X, got)


def test_kernels_registry_has_ref_and_test():
    """Every name in ``KERNELS`` has a ``<name>_ref`` plain version and a
    parity test in this file (the port's side of the R003 contract)."""
    here = globals()
    for name in tk.KERNELS:
        assert callable(getattr(tref, f"{name}_ref"))
        assert callable(getattr(tops, name))
        assert any(k.startswith(f"test_{name}") for k in here), name
    tk.reset_launch_counts()
    assert tk.launch_counts() == {k: 0 for k in tk.KERNELS}


def test_plain_version_does_not_count_launches():
    tk.reset_launch_counts()
    X, bwd = _inputs(np.random.default_rng(5), 10, 7)
    _port_nfa_step(X, bwd)
    _port_segment_or(X, np.array([0, 0, 1, 1, 1, 2, 3, 3, 4, 6]), 7)
    _port_segmented_or_scan(X, np.ones(10, dtype=np.int32))
    words = tops.words_to_tensor(_bitvector_words(
        np.random.default_rng(6), 600, 0.5)[0], "cpu")
    tops.rank1(words, tops.build_rank_directory(words),
               torch.tensor([0, 7, 600], dtype=torch.int32))
    inputs = _superstep_inputs("random", 20, 40, 5, 0.5)
    _port_superstep(*inputs)
    assert tk.launch_counts() == {k: 0 for k in tk.KERNELS}


def test_wrapper_checks_inputs_and_never_falls_back():
    X = torch.zeros((4, 1), dtype=torch.int32)
    bwd = torch.zeros((3, 1), dtype=torch.int32)
    with pytest.raises(ValueError):       # the CUDA wrapper wants CUDA
        tnfa.nfa_step_cuda(X, bwd)
    with pytest.raises(TypeError):
        tops.nfa_step(X.to(torch.int64), bwd)
    with pytest.raises(ValueError):       # table wider than the words
        tops.nfa_step(X, torch.zeros((33, 1), dtype=torch.int32))
    with pytest.raises(ValueError):
        tops.nfa_step(X, torch.zeros((3, 2), dtype=torch.int32))
    with pytest.raises(ValueError):       # no third device kind
        tops.nfa_step(X.to("meta"), bwd.to("meta"))


# -- segment_or and segmented_or_scan ------------------------------------------

def _port_segment_or(vals, seg, V):
    out = tops.segment_or(tops.words_to_tensor(vals, "cpu"),
                          torch.from_numpy(np.asarray(seg, dtype=np.int32)),
                          V)
    assert out.dtype == torch.int32 and out.shape == (V, vals.shape[1])
    return tops.tensor_to_words(out)


def _port_segmented_or_scan(vals, flags):
    out = tops.segmented_or_scan(
        tops.words_to_tensor(vals, "cpu"),
        torch.from_numpy(np.asarray(flags, dtype=np.int32)))
    assert out.dtype == torch.int32 and out.shape == vals.shape
    return tops.tensor_to_words(out)


def _scatter_or(vals, seg, V):
    want = np.zeros((V, vals.shape[1]), dtype=np.uint32)
    np.bitwise_or.at(want, seg, vals)
    return want


@pytest.mark.parametrize("E,W,V", [(1, 1, 1), (10, 1, 4), (3000, 2, 50),
                                   (2050, 1, 2000), (1024, 3, 7)])
def test_segment_or_shapes(E, W, V):
    rng = np.random.default_rng(E * 7 + W * 3 + V)
    seg = np.sort(rng.integers(0, V, E)).astype(np.int32)
    vals = rng.integers(0, 2**32, (E, W), dtype=np.uint32)
    got = _port_segment_or(vals, seg, V)
    np.testing.assert_array_equal(got, np.asarray(jops.segment_or(vals, seg,
                                                                  V)))
    np.testing.assert_array_equal(got, _scatter_or(vals, seg, V))


@settings(max_examples=10, deadline=None)
@given(st.integers(1, 3000), st.integers(1, 3), st.integers(1, 100),
       st.integers(0, 2**31 - 1))
def test_segment_or_property(E, W, V, seed):
    """Against ``np.bitwise_or.at``, with most rows zero (as on the packed
    BFS path) and ids in any order: the port's scatter needs no sort."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, V, E).astype(np.int32)
    vals = rng.integers(0, 2**32, (E, W), dtype=np.uint32)
    vals[rng.random(E) < 0.7] = 0
    np.testing.assert_array_equal(_port_segment_or(vals, seg, V),
                                  _scatter_or(vals, seg, V))


def test_segment_or_empty_inputs_and_empty_segments():
    vals = np.zeros((0, 2), dtype=np.uint32)
    np.testing.assert_array_equal(_port_segment_or(vals, [], 5),
                                  np.zeros((5, 2), dtype=np.uint32))
    vals = np.array([[1], [2], [4]], dtype=np.uint32)
    np.testing.assert_array_equal(_port_segment_or(vals, [1, 1, 3], 5),
                                  [[0], [3], [0], [4], [0]])


@pytest.mark.parametrize("E,W,V", [(10, 1, 4), (3000, 2, 50)])
def test_segment_or_ref_matches_reference(E, W, V):
    """``ref.segment_or_ref``, the plain version the card's kernel is
    held to in ``test_torch_cuda.py``, against the JAX package's own
    oracle ``ref.segment_or_ref`` (the R003 contract: each ``KERNELS``
    entry's ``_ref`` is named by a CPU test)."""
    rng = np.random.default_rng(E + 5 * W + V)
    seg = np.sort(rng.integers(0, V, E)).astype(np.int32)
    vals = rng.integers(0, 2**32, (E, W), dtype=np.uint32)
    vals[rng.random(E) < 0.5] = 0
    got = tops.tensor_to_words(tref.segment_or_ref(
        tops.words_to_tensor(vals, "cpu"), torch.from_numpy(seg), V))
    np.testing.assert_array_equal(got, np.asarray(jax.jit(
        jref.segment_or_ref, static_argnums=2)(jnp.asarray(vals),
                                               jnp.asarray(seg), V)))


def _scan_inputs(E, W, p):
    rng = np.random.default_rng(E + W)
    vals = rng.integers(0, 2**32, (E, W), dtype=np.uint32)
    flags = (rng.random(E) < p).astype(np.int32)
    flags[0] = 1
    return vals, flags


@pytest.mark.parametrize("E,W,p", [(2500, 2, 0.1), (1, 1, 0.5),
                                   (3000, 1, 0.001), (1500, 3, 0.5)])
def test_segmented_or_scan_matches_reference(E, W, p):
    """The whole array against the JAX package's associative-scan
    oracle: segments run across the JAX kernel's tiles."""
    vals, flags = _scan_inputs(E, W, p)
    np.testing.assert_array_equal(
        _port_segmented_or_scan(vals, flags),
        np.asarray(jax.jit(jref.segmented_or_scan_ref)(
            jnp.asarray(vals), jnp.asarray(flags))))


def test_segmented_or_scan_first_tile_matches_pallas():
    """The JAX kernel scans within tiles only, so its first ``TILE_E``
    rows, which depend on those rows alone, are the whole scan's."""
    vals, flags = _scan_inputs(2500, 2, 0.1)
    assert tseg.TILE_E == J_TILE_E
    T = tseg.TILE_E
    tile = np.asarray(j_scan_tiles(jnp.asarray(vals[:T]),
                                   jnp.asarray(flags[:T])))
    np.testing.assert_array_equal(_port_segmented_or_scan(vals, flags)[:T],
                                  tile)


@pytest.mark.parametrize("E,W", [(1, 1), (2999, 1), (1000, 3)])
def test_segmented_or_scan_any_nonzero_flag_starts(E, W):
    """Flags other than 1 (negative ones too) start segments, and row 0
    starts one though its flag is 0, as in the JAX package's oracle."""
    rng = np.random.default_rng(E * W)
    vals = rng.integers(0, 2**32, (E, W), dtype=np.uint32)
    flags = np.where(rng.random(E) < 0.05,
                     rng.choice([2, -1, 7, 1 << 30], E), 0).astype(np.int32)
    flags[0] = 0
    np.testing.assert_array_equal(
        _port_segmented_or_scan(vals, flags),
        np.asarray(jax.jit(jref.segmented_or_scan_ref)(
            jnp.asarray(vals), jnp.asarray(flags))))


def test_seq_scratch_is_per_stream_and_cleared_when_it_wraps():
    """The look-back scans' scratch: one per (device, stream), zero when
    new, kept while large enough, replaced when too small, and cleared
    once when the sequence number reaches its limit."""
    from repro_torch.kernels import _build
    scratch = _build.SeqScratch()
    cpu = torch.device("cpu")
    a, seq_a = scratch.take(cpu, 1, 10)
    b, seq_b = scratch.take(cpu, 2, 10)
    assert a is not b and seq_a == seq_b == 1
    assert not a.any() and a.dtype == torch.int64 and a.numel() == 10
    a.fill_(5)
    again, seq = scratch.take(cpu, 1, 4)
    assert again is a and seq == 2
    scratch.LIMIT = 4
    same, seq = scratch.take(cpu, 1, 10)
    assert same is a and seq == 3
    wrapped, seq = scratch.take(cpu, 1, 10)
    assert wrapped is a and seq == 1 and not a.any()
    bigger, seq = scratch.take(cpu, 1, 11)
    assert bigger is not a and seq == 1 and bigger.numel() == 11
    scratch.drop(cpu, 1)
    assert scratch.take(cpu, 1, 11)[1] == 1


# -- rank ------------------------------------------------------------------------

def _bitvector_words(rng, n_bits, density):
    """Packed words of ``n_bits`` random bits, padded as the JAX package's
    rank tests pad them (whole superblocks plus one)."""
    bits = rng.random(n_bits) < density
    nw = ((n_bits + 511) // 512) * 16 + 16
    padded = np.zeros(nw * 32, dtype=bool)
    padded[:n_bits] = bits
    words = np.packbits(padded.reshape(nw, 32), axis=1,
                        bitorder="little").view(np.uint32).ravel()
    return words, bits


@pytest.mark.parametrize("n_bits", [100, 515, 8192, 40000])
def test_superblock_popcounts_and_directory(n_bits):
    """The JAX package's ``test_rank_kernel`` cases and more: the
    popcounts and the directory equal the JAX package's, the directory's
    steps are the popcounts, and ``rank1`` at 200 random offsets equals a
    numpy prefix sum."""
    rng = np.random.default_rng(n_bits)
    words, bits = _bitvector_words(rng, n_bits, 0.5)
    tw = tops.words_to_tensor(words, "cpu")
    pc = tops.superblock_popcounts(tw)
    assert pc.dtype == torch.int32
    np.testing.assert_array_equal(
        pc.numpy(), np.asarray(jref.superblock_popcounts_ref(
            jnp.asarray(words))))
    directory = tops.build_rank_directory(tw)
    assert directory.dtype == torch.int32
    np.testing.assert_array_equal(directory.numpy(),
                                  np.asarray(jops.build_rank_directory(words)))
    np.testing.assert_array_equal(np.diff(directory.numpy()), pc.numpy())
    q = rng.integers(0, n_bits + 1, 200)
    got = tops.rank1(tw, directory, torch.from_numpy(q.astype(np.int32)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.concatenate([[0], np.cumsum(bits)])[q])


@pytest.mark.parametrize("n_bits", [100, 515, 8192, 40000])
def test_rank1_matches_reference(n_bits):
    """Against the JAX package's kernel pipeline, its end-to-end oracle
    and a numpy prefix sum, at offsets that include 0, n and word and
    superblock boundaries (the i & 31 == 0 case)."""
    rng = np.random.default_rng(n_bits + 1)
    words, bits = _bitvector_words(rng, n_bits, 0.3)
    q = np.concatenate([rng.integers(0, n_bits + 1, 300),
                        [0, n_bits, 32, 512, 31, 511, 513]])
    q = q[q <= n_bits].astype(np.int32)
    tw = tops.words_to_tensor(words, "cpu")
    got = tops.rank1(tw, tops.build_rank_directory(tw), torch.from_numpy(q))
    assert got.dtype == torch.int32
    got = got.numpy()
    jdir = jops.build_rank_directory(jnp.asarray(words))
    np.testing.assert_array_equal(got, np.asarray(
        jops.rank1(jnp.asarray(words), jdir, q)))
    np.testing.assert_array_equal(got, np.asarray(
        jref.rank1_ref(jnp.asarray(words), jnp.asarray(q))))
    np.testing.assert_array_equal(got, np.concatenate([[0],
                                                       np.cumsum(bits)])[q])
    np.testing.assert_array_equal(
        tref.rank1_ref(tw, torch.from_numpy(q)).numpy(), got)


@pytest.mark.parametrize("n_bits", [100, 8192])
def test_rank1_padded_range_matches_reference(n_bits):
    """Every offset of the padded range, 0 to 32 * NW, whose last
    windows reach past the words and whose last directory entry is the
    total: the clamped semantics (each word index and the directory
    index clamped into their arrays, the masks from the unclamped
    positions) that the card's vector path must keep, held to the JAX
    package's ``ops.rank1``."""
    rng = np.random.default_rng(n_bits + 2)
    words, _bits = _bitvector_words(rng, n_bits, 0.5)
    words[-16:] = rng.integers(0, 2**32, 16, dtype=np.uint32)  # set padding
    NW = words.shape[0]
    q = rng.permutation(np.arange(32 * NW + 1)).astype(np.int32)
    tw = tops.words_to_tensor(words, "cpu")
    tdir = tops.build_rank_directory(tw)
    got = tops.rank1(tw, tdir, torch.from_numpy(q)).numpy()
    jdir = jops.build_rank_directory(jnp.asarray(words))
    np.testing.assert_array_equal(tdir.numpy(), np.asarray(jdir))
    np.testing.assert_array_equal(got, np.asarray(
        jops.rank1(jnp.asarray(words), jdir, q)))
    np.testing.assert_array_equal(
        got, tref.rank1_window_ref(tw, tdir, torch.from_numpy(q)).numpy())


def test_new_wrappers_check_inputs_and_never_fall_back():
    vals = torch.zeros((4, 2), dtype=torch.int32)
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):       # the CUDA wrappers want CUDA
        tseg.segment_or_cuda(vals, ids, 3)
    with pytest.raises(ValueError):
        tseg.segmented_or_scan_cuda(vals, ids)
    with pytest.raises(TypeError):
        tops.segment_or(vals, ids.to(torch.int64), 3)
    with pytest.raises(ValueError):
        tops.segment_or(vals, ids[:3], 3)
    with pytest.raises(ValueError):
        tops.segment_or(vals, ids, -1)
    with pytest.raises(TypeError):
        tops.segmented_or_scan(vals.to(torch.int64), ids)
    with pytest.raises(ValueError):       # no third device kind
        tops.segment_or(vals.to("meta"), ids.to("meta"), 3)
    words = torch.zeros(32, dtype=torch.int32)
    directory = torch.zeros(3, dtype=torch.int32)
    q = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError):
        trank.superblock_popcounts_cuda(words)
    with pytest.raises(ValueError):
        trank.rank1_cuda(words, directory, q)
    with pytest.raises(ValueError):
        trank.rank_directory_cuda(words)
    with pytest.raises(ValueError):       # not whole superblocks
        tops.superblock_popcounts(words[:20])
    with pytest.raises(TypeError):
        tops.rank1(words, directory, q.to(torch.int64))
    with pytest.raises(ValueError):
        tops.rank1(words, directory[:0], q)


# -- packed_superstep -----------------------------------------------------------

def _superstep_inputs(edges, V, E, S, live, seed=0):
    """Frontier, visited, table and edge arrays of one packed BFS
    superstep, made with numpy.  ``edges``: "random" takes the completed
    edges of ``random_graph`` (sorted by subject, as ``DenseGraph``
    keeps them); "hub" draws E subjects with the scale-free fixture's
    node law (weight rank**-0.8), sorted, over the first 3/4 of the nodes
    (the rest isolated).  ``live``: share of frontier rows with a
    non-zero word; every frontier word has bits at and above S too."""
    rng = np.random.default_rng(seed)
    W = (S + 31) // 32
    if edges == "random":
        dg = JDenseGraph.from_graph(random_graph(V, 3, E, seed=seed,
                                                 pred_zipf=False))
        subj, pred, obj = (np.asarray(a) for a in (dg.subj, dg.pred, dg.obj))
        L = dg.num_labels
    else:
        L, used = 6, 3 * V // 4
        wn = 1.0 / np.arange(1, used + 1) ** 0.8
        subj = np.sort(rng.choice(used, size=E, p=wn / wn.sum()))
        pred = rng.integers(0, L, E)
        obj = rng.integers(0, used, E)
    assert S < 32 * W
    f = rng.integers(0, 2**32, (V, W), dtype=np.uint32)
    f[:, -1] |= np.uint32(1 << 31)            # a bit >= S in every row
    f[rng.random(V) >= live] = 0
    v = rng.integers(0, 2**32, (V, W), dtype=np.uint32)
    v[rng.random((V, W)) < 0.7] = 0
    Bp = rng.integers(0, 2**32, (L, W), dtype=np.uint32)
    bwd = rng.integers(0, 2**32, (S, W), dtype=np.uint32)
    spare = rng.integers(0, 2**32, (V, W), dtype=np.uint32)
    return (f, v, spare, Bp, bwd, subj.astype(np.int32),
            pred.astype(np.int32), obj.astype(np.int32))


def _grouped(subj, pred, obj, num_objects, inert_label, rows=1):
    """numpy edge ids grouped by object on the CPU, and scratch for
    ``rows`` rows."""
    layout = tsup.group_by_object(
        *(torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
          for a in (subj, pred, obj)), num_objects, inert_label)
    return layout, tsup.new_scratch(layout, rows)


def _port_superstep(f, v, spare, Bp, bwd, subj, pred, obj, stamp=7):
    """The port's superstep on CPU copies, one row (the flag at ``stamp -
    1``, so the call does its work), over the edges grouped by object:
    (v, nxt, spare, flag) after."""
    t = [tops.words_to_tensor(a, "cpu")[None]
         for a in (f, v, spare, Bp, bwd)]
    nxt = torch.zeros_like(t[0])
    flag = torch.full((1,), stamp - 1, dtype=torch.int32)
    tops.packed_superstep(t[0], t[1], nxt, t[2], flag, stamp, t[3], t[4],
                          *_grouped(subj, pred, obj, f.shape[0],
                                    Bp.shape[0]))
    np.testing.assert_array_equal(tops.tensor_to_words(t[0][0]), f)
    return (tops.tensor_to_words(t[1][0]), tops.tensor_to_words(nxt[0]),
            tops.tensor_to_words(t[2][0]), int(flag[0]))


@pytest.mark.parametrize("edges,V,E,S,live", [
    ("random", 40, 150, 5, 0.3), ("random", 60, 300, 33, 0.3),
    ("hub", 80, 400, 20, 0.3), ("hub", 80, 400, 33, 1.0),
    ("hub", 50, 200, 33, 0.0), ("random", 30, 100, 12, 0.0)])
def test_packed_superstep_matches_reference(edges, V, E, S, live):
    """Word for word against the JAX package's superstep body: the
    gathers, ``ops.nfa_step`` (Pallas, interpret mode), ``ops.segment_or``
    and the and-not, with the JAX loop's visited ``v | f``."""
    f, v, spare, Bp, bwd, subj, pred, obj = _superstep_inputs(
        edges, V, E, S, live, seed=V + E + S)
    vis = v | f
    X = jnp.asarray(f)[obj] & jnp.asarray(Bp)[pred]
    Y = jops.nfa_step(X, jnp.asarray(bwd))
    want = np.asarray(jops.segment_or(Y, subj, V)) & ~vis
    got_v, nxt, got_spare, flag = _port_superstep(f, v, spare, Bp, bwd,
                                                  subj, pred, obj)
    np.testing.assert_array_equal(nxt, want)
    np.testing.assert_array_equal(got_v, vis)
    assert not got_spare.any()
    assert flag == (7 if want.any() else 6)
    assert bool(want.any()) == (live > 0)


@pytest.mark.parametrize("edges,V,E,S,live", [
    ("random", 40, 150, 5, 0.3), ("hub", 80, 400, 33, 1.0)])
def test_packed_superstep_ref_matches_reference(edges, V, E, S, live):
    """``ref.packed_superstep_ref``, the plain version the card's kernel
    is held to in ``test_torch_cuda.py``, on the raw edge arrays against
    the JAX package's superstep body (the R003 contract: each
    ``KERNELS`` entry's ``_ref`` is named by a CPU test)."""
    f, v, spare, Bp, bwd, subj, pred, obj = _superstep_inputs(
        edges, V, E, S, live, seed=2 * V + E + S)
    vis = v | f
    X = jnp.asarray(f)[obj] & jnp.asarray(Bp)[pred]
    Y = jops.nfa_step(X, jnp.asarray(bwd))
    want = np.asarray(jops.segment_or(Y, subj, V)) & ~vis
    t = [tops.words_to_tensor(a, "cpu")[None]
         for a in (f, v, spare, Bp, bwd)]
    nxt = torch.zeros_like(t[0])
    flag = torch.full((1,), 6, dtype=torch.int32)
    tref.packed_superstep_ref(t[0], t[1], nxt, t[2], flag, 7, t[3], t[4],
                              *(torch.from_numpy(a) for a in (subj, pred,
                                                              obj)))
    np.testing.assert_array_equal(tops.tensor_to_words(nxt[0]), want)
    np.testing.assert_array_equal(tops.tensor_to_words(t[1][0]), vis)
    assert not t[2].any()
    assert int(flag[0]) == (7 if want.any() else 6)


def test_packed_superstep_wrappers_check_inputs_and_never_fall_back():
    from dataclasses import replace
    z = torch.zeros((1, 4, 1), dtype=torch.int32)
    ids = torch.zeros(3, dtype=torch.int32)
    flag = torch.zeros(1, dtype=torch.int32)
    bwd = torch.zeros((1, 2, 1), dtype=torch.int32)
    lay = tsup.group_by_object(ids, ids, ids, 4, 1)
    scr = tsup.new_scratch(lay, 1)
    edges = (lay, scr)

    def state():
        return [torch.zeros_like(z) for _ in range(4)]

    with pytest.raises(ValueError):       # the CUDA wrapper wants CUDA
        tsup.packed_superstep_cuda(*state(), flag, 1, z, bwd, *edges)
    with pytest.raises(TypeError):
        tops.packed_superstep(*state(), flag, 1, z, bwd,
                              replace(lay, subj=lay.subj.long()), scr)
    with pytest.raises(ValueError):       # state buffers of two shapes
        tops.packed_superstep(*state()[:3], z[:, :2], flag, 1, z, bwd,
                              *edges)
    with pytest.raises(ValueError):       # one buffer twice
        f, v, nxt, _ = state()
        tops.packed_superstep(f, v, nxt, f, flag, 1, z, bwd, *edges)
    with pytest.raises(ValueError):       # table wider than the words
        tops.packed_superstep(*state(), flag, 1, z,
                              torch.zeros((1, 33, 1), dtype=torch.int32),
                              *edges)
    with pytest.raises(ValueError):       # edge ids of two lengths
        tops.packed_superstep(*state(), flag, 1, z, bwd,
                              replace(lay, pred=lay.pred[:2]), scr)
    with pytest.raises(ValueError):       # tables of another row count
        tops.packed_superstep(*state(), flag, 1, z,
                              torch.zeros((2, 2, 1), dtype=torch.int32),
                              *edges)
    with pytest.raises(ValueError):       # words without a row axis
        tops.packed_superstep(*[t[0] for t in state()], flag, 1, z[0],
                              bwd[0], *edges)
    with pytest.raises(ValueError):       # grouped over another frontier
        tops.packed_superstep(*state(), flag, 1, z, bwd,
                              tsup.group_by_object(ids, ids, ids, 5, 1), scr)
    with pytest.raises(ValueError):       # a worklist too small for R
        two = [torch.zeros((2, 4, 1), dtype=torch.int32) for _ in range(4)]
        tops.packed_superstep(*two, flag, 1, two[0].clone(),
                              torch.zeros((2, 2, 1), dtype=torch.int32),
                              *edges)
    with pytest.raises(ValueError):       # counters of another shape
        tops.packed_superstep(*state(), flag, 1, z, bwd, lay,
                              replace(scr, counters=scr.counters[:2]))
    with pytest.raises(ValueError):       # no third device kind
        meta = replace(lay, offsets=lay.offsets.to("meta"),
                       subj=lay.subj.to("meta"), pred=lay.pred.to("meta"))
        tops.packed_superstep(*[t.to("meta") for t in state()],
                              flag.to("meta"), 1, z.to("meta"),
                              bwd.to("meta"), meta,
                              replace(scr, work=scr.work.to("meta"),
                                      counters=scr.counters.to("meta")))


def _row_inputs(R, V, E, S, L, live, seed):
    """R rows of one superstep's state over one edge list, made with
    numpy: unsorted subjects, labels in [0, L] (L the inert label, its
    table rows zero), each row with its own frontier, visited words and
    tables; every frontier word has bits at and above S too."""
    rng = np.random.default_rng(seed)
    W = (S + 31) // 32
    assert S < 32 * W
    subj, obj = rng.integers(0, V, (2, E)).astype(np.int32)
    pred = rng.integers(0, L + 1, E).astype(np.int32)
    f = rng.integers(0, 2**32, (R, V, W), dtype=np.uint32)
    f[..., -1] |= np.uint32(1 << 31)
    f[rng.random((R, V)) >= live] = 0
    v = rng.integers(0, 2**32, (R, V, W), dtype=np.uint32)
    v[rng.random((R, V, W)) < 0.7] = 0
    Bp = rng.integers(0, 2**32, (R, L + 1, W), dtype=np.uint32)
    Bp[:, L] = 0
    bwd = rng.integers(0, 2**32, (R, S, W), dtype=np.uint32)
    spare = rng.integers(0, 2**32, (R, V, W), dtype=np.uint32)
    return f, v, spare, Bp, bwd, subj, pred, obj


def _rows_superstep(f, v, spare, Bp, bwd, subj, pred, obj, stamp, flag0):
    """The plain superstep on CPU copies of [R, ...] arrays: (f, v, nxt,
    spare, flag) after."""
    t = [tops.words_to_tensor(a, "cpu") for a in (f, v, spare, Bp, bwd)]
    nxt = torch.zeros_like(t[0])
    flag = torch.full((1,), flag0, dtype=torch.int32)
    tops.packed_superstep(t[0], t[1], nxt, t[2], flag, stamp, t[3], t[4],
                          *_grouped(subj, pred, obj, f.shape[1],
                                    Bp.shape[1] - 1, rows=f.shape[0]))
    return [tops.tensor_to_words(a) for a in (t[0], t[1], nxt, t[2])] + \
        [int(flag[0])]


@pytest.mark.parametrize("R,V,E,S,L,live", [
    (3, 40, 150, 5, 4, 0.5), (4, 30, 120, 33, 6, 0.3), (2, 25, 90, 20, 3, 0.0),
    (5, 50, 300, 12, 2, 1.0)])
def test_packed_superstep_rows_match_separate_rows(R, V, E, S, L, live):
    """The row axis is R independent supersteps: one call of R rows
    equals R calls of one row each, word for word (the flag is set when
    any row found a word); a call whose flag is below stamp - 1 changes
    nothing."""
    arrays = _row_inputs(R, V, E, S, L, live, seed=R * V + S)
    got = _rows_superstep(*arrays, stamp=4, flag0=3)
    flags = []
    for r in range(R):
        one = _rows_superstep(*(a[r:r + 1] for a in arrays[:5]),
                              *arrays[5:], stamp=4, flag0=3)
        for g_, w in zip(got[:4], one[:4]):
            np.testing.assert_array_equal(g_[r], w[0])
        flags.append(one[4])
    assert got[4] == max(flags) == (4 if got[2].any() else 3)
    assert bool(got[2].any()) == (live > 0)
    idle = _rows_superstep(*arrays, stamp=4, flag0=2)
    for a, b in zip(idle[:2] + idle[3:4], arrays[:3]):
        np.testing.assert_array_equal(a, b)
    assert not idle[2].any() and idle[4] == 2


def _reference_hetero(g, exprs, starts):
    """The JAX dense engine's stacked int8 plane tables and start planes
    for one row per (expression, start), padded to the bucket width."""
    import jax.numpy as jnp
    from repro.core import regex as jrx
    from repro.core.dense import DenseRPQ as JDense, _plane_tables, _start_row
    eng = JDense(g)
    autos = [eng._automaton(jrx.parse(e)) for e in exprs]
    S_pad = eng._pad_width(max(a.m + 1 for a in autos))
    L, V = eng.dg.num_labels, g.num_nodes
    B = np.zeros((len(autos), L + 1, S_pad), dtype=np.int8)
    PRED = np.zeros((len(autos), S_pad, S_pad), dtype=np.int8)
    planes = np.zeros((len(autos), V, S_pad), dtype=np.int8)
    for r, (a, s) in enumerate(zip(autos, starts)):
        Br, Pr, _F = _plane_tables(a, L)
        B[r, :, :a.m + 1] = np.asarray(Br)
        PRED[r, :a.m + 1, :a.m + 1] = np.asarray(Pr)
        planes[r, s, :a.m + 1] = _start_row(a)
    return eng.dg, B, PRED, planes, jnp


def test_packed_superstep_rows_match_reference_bfs_hetero():
    """Row-axis supersteps, the plain version, against the JAX package's
    ``_bfs_chunk_hetero`` (one superstep a call, each row its own
    automaton and width padding) and ``_bfs_hetero`` (the fixpoint):
    frontier and visited planes word for word at every superstep, and
    the port's loop (``dense.bfs_rows``) reaches the same visited planes
    in the same supersteps."""
    from repro.core.dense import _bfs_chunk_hetero, _bfs_hetero
    from repro_torch.core.dense import Edges, bfs_rows
    g = random_graph(30, 3, 110, seed=12, pred_zipf=False)
    exprs = ["0/1*", "(0|2)+/^1", "2", "0/1/2/0/1*/2"]
    dg, B, PRED, planes, jnp = _reference_hetero(g, exprs, [0, 3, 7, 11])
    S_pad = planes.shape[2]
    ids = [torch.from_numpy(np.array(a)) for a in (dg.subj, dg.pred,
                                                    dg.obj)]
    edges = Edges.build(*ids, g.num_nodes, dg.num_labels)
    scratch = tsup.new_scratch(edges.grouped, len(exprs))
    Bp, Pp = (tops.words_to_tensor(tops.pack_bits(a), "cpu")
              for a in (B, PRED))
    f = v = jnp.asarray(planes)
    pf = tops.words_to_tensor(tops.pack_bits(planes), "cpu")
    pv = pf.clone()                     # the JAX visited, which holds f
    steps = 0
    while bool(jnp.any(f > 0)):
        f, v, its = _bfs_chunk_hetero(dg.subj, dg.pred, dg.obj,
                                      jnp.asarray(B), jnp.asarray(PRED), f, v,
                                      g.num_nodes, 1)
        nxt = torch.zeros_like(pf)
        flag = torch.full((1,), steps, dtype=torch.int32)
        tops.packed_superstep(pf, pv, nxt, torch.zeros_like(pf), flag,
                              steps + 1, Bp, Pp, edges.grouped, scratch)
        steps += int(its)
        np.testing.assert_array_equal(
            tops.unpack_bits(tops.tensor_to_words(nxt), S_pad), np.asarray(f))
        np.testing.assert_array_equal(
            tops.unpack_bits(tops.tensor_to_words(pv | nxt), S_pad),
            np.asarray(v))
        assert int(flag[0]) == (steps if bool(jnp.any(f > 0)) else steps - 1)
        pf, pv = nxt, pv | nxt
    want = _bfs_hetero(dg.subj, dg.pred, dg.obj, jnp.asarray(B),
                       jnp.asarray(PRED), jnp.asarray(planes), g.num_nodes,
                       g.num_nodes * S_pad + 1)
    start = tops.words_to_tensor(tops.pack_bits(planes), "cpu")
    vis, front, it = bfs_rows(edges, Bp, Pp, start,
                              g.num_nodes * S_pad + 1)
    np.testing.assert_array_equal(
        tops.unpack_bits(tops.tensor_to_words(vis), S_pad), np.asarray(want))
    assert it == steps > 3 and not bool(front.any())
    for cap in (1, 2, steps - 1):
        _vis, front, it = bfs_rows(edges, Bp, Pp, tops.words_to_tensor(
            tops.pack_bits(planes), "cpu"), cap)
        assert it == cap and bool(front.any())
