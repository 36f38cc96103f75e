"""repro_torch.utils: flat paths and leaf order equal the JAX package's."""

import collections

import numpy as np
import pytest
import torch

from repro.utils import flatten_with_paths as jax_flatten
from repro_torch.utils import (
    ceil_div,
    content_hash,
    crc32_of,
    flatten_with_paths,
    from_numpy_tree,
    round_up,
)

NT = collections.namedtuple("NT", "zeta alpha")

TREES = {
    "nested": {
        "z": [1, (2.5, NT(3, "s"))],
        "a": {"y": None, "x": np.float32(5)},
        "m": collections.OrderedDict([("q", 1), ("b", 2)]),
    },
    "unsorted_insertion": {"b": {"d": 1, "c": 2}, "a": [3, {"f": 4, "e": 5}], "_": 6},
    "namedtuple_root": NT(zeta=[1, 2], alpha={"k": 3}),
    "tuple_root": (1, [2, (3,)], {"x": 4}),
    "leaf_root": 7,
    "empty": {"k": [], "j": (), "n": None},
    "digit_keys": {"10": 1, "9": 2, "1/0": 3},
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_flat_keys_and_leaf_order_equal_jax(name):
    tree = TREES[name]
    want, _ = jax_flatten(tree)
    got, treedef = flatten_with_paths(tree)
    assert list(got) == list(want)  # byte-identical paths, same order
    assert list(got.values()) == list(want.values())
    assert treedef.num_leaves == len(want)


@pytest.mark.parametrize("name", sorted(TREES))
def test_unflatten_round_trips(name):
    tree = TREES[name]
    flat, treedef = flatten_with_paths(tree)
    boxed = {k: np.array([i]) for i, k in enumerate(flat)}  # fresh leaves
    back = treedef.unflatten(boxed)
    back_flat, _ = flatten_with_paths(back)
    assert list(back_flat) == list(flat)
    assert all(back_flat[k] is boxed[k] for k in flat)
    if list(flat) != ["."]:  # a leaf root comes back as the new leaf
        assert type(back) is type(tree)


def test_unflatten_rebuilds_container_types():
    tree = {"t": NT(1, [2, (3, 4)]), "o": collections.OrderedDict([("z", 1), ("a", 2)])}
    flat, treedef = flatten_with_paths(tree)
    back = treedef.unflatten(flat)
    assert back == tree
    assert isinstance(back["t"], NT) and isinstance(back["t"].alpha[1], tuple)
    assert list(back["o"]) == ["z", "a"]


def test_unflatten_missing_leaf_raises():
    _, treedef = flatten_with_paths({"a": 1, "b": 2})
    with pytest.raises(KeyError):
        treedef.unflatten({"a": 1})


def test_duplicate_flat_key_raises():
    with pytest.raises(ValueError):
        flatten_with_paths({"a/b": 1, "a": {"b": 2}})


def test_from_numpy_tree_keeps_bytes_and_structure():
    import ml_dtypes  # the JAX package's bfloat16

    rng = np.random.default_rng(0)
    tree = {
        "f": rng.standard_normal((3, 2)).astype(np.float32),
        "b": rng.standard_normal(5).astype(np.float32).astype(ml_dtypes.bfloat16),
        "i": [np.arange(4, dtype=np.int8)],
        "s": "tag",
    }
    out = from_numpy_tree(tree, "cpu")
    assert out["s"] == "tag"
    assert out["b"].dtype == torch.bfloat16
    assert out["b"].view(torch.int16).numpy().tobytes() == tree["b"].tobytes()
    assert out["f"].numpy().tobytes() == tree["f"].tobytes()
    assert out["i"][0].dtype == torch.int8


def test_hash_and_sizes_match_jax_helpers():
    from repro import utils as ju

    buf = bytes(range(256)) * 3
    assert content_hash(buf) == ju.content_hash(buf)
    assert crc32_of(memoryview(buf)) == ju.crc32_of(buf)
    for a, b in [(0, 3), (7, 3), (9, 3), (1, 1)]:
        assert ceil_div(a, b) == ju.ceil_div(a, b)
        assert round_up(a, b) == ju.round_up(a, b)


def test_byte_counts_and_formatting_match_jax_helpers():
    """``nbytes_of``/``tree_nbytes`` over numpy arrays (bf16 among them)
    equal the JAX package's, and over the same tensors and TensorSpecs;
    ``human_bytes`` and ``prod`` format and multiply as its do."""
    import ml_dtypes

    from repro import utils as ju
    from repro_torch.models.model import TensorSpec
    from repro_torch.utils import human_bytes, nbytes_of, prod, tree_nbytes

    tree = {"f": np.zeros((3, 5), np.float32), "b": np.zeros(7, ml_dtypes.bfloat16),
            "i": [np.zeros((2, 2, 2), np.int8)], "x": np.float64(1.0), "s": "tag"}
    assert tree_nbytes(tree) == ju.tree_nbytes(tree) == 60 + 14 + 8 + 8
    tensors = from_numpy_tree({k: v for k, v in tree.items() if k != "s"}, "cpu")
    assert tree_nbytes(tensors) == ju.tree_nbytes(tree)
    assert nbytes_of(TensorSpec((4, 6), torch.bfloat16)) == 48 and nbytes_of("tag") == 0
    for n in (0, 1023, 1024, 5 * 2**20 + 17, 3.5 * 2**40, 2**52):
        assert human_bytes(n) == ju.human_bytes(n)
    assert prod((2, 3, 7)) == ju.prod((2, 3, 7)) == 42 and prod(()) == 1


def test_step_timer_laps():
    import time

    from repro_torch.utils import StepTimer

    t = StepTimer()
    time.sleep(0.01)
    first = t.lap("a")
    second = t.lap("b")
    assert first >= 0.01 and 0 <= second < first
    assert [name for name, _ in t.laps] == ["a", "b"]
