"""The port's kernels against the JAX package's, bit for bit.

On the CPU the port's ``nfa_step`` runs its plain PyTorch version; the
JAX side runs the Pallas kernel in interpret mode (as
``tests/test_kernels.py`` does) and its pure-jnp oracle.  The CUDA
kernel itself is held to the plain version in ``test_torch_cuda.py``,
which runs only on a machine with a card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_compat import given, settings, strategies as st

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.kernels.nfa_step import pack_block_diagonal as j_pack  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.kernels import ops as tops, ref as tref  # noqa: E402
from repro_torch.kernels import nfa_step as tnfa  # noqa: E402

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
    assert tk.launch_counts()["nfa_step"] == 0


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
