"""``repro_torch.tree`` against ``jax.tree``: the port's one set of tree
walkers (parameters, gradients, optimizer states, checkpoints, health
snapshots) flattens, maps and rebuilds as the JAX package's trees do."""

from __future__ import annotations

import gc
import weakref

import jax
import numpy as np
import pytest
import torch

from repro_torch.optim import AdafactorState, AdamWState
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_map_split, tree_unflatten


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": {"z": rng.standard_normal(3), "a": rng.standard_normal((2, 2))},
            "blocks": [{"k": rng.standard_normal(4)}, (rng.standard_normal(1), None)],
            "b": rng.standard_normal(2)}


@pytest.mark.parametrize("tree", [_tree(0), [np.ones(2), np.zeros(3)], (np.ones(1),),
                                  np.arange(3.0), None, {}],
                         ids=["nested", "list", "tuple", "leaf", "none", "empty"])
def test_leaves_and_rebuild_as_jax(tree):
    leaves, treedef = tree_flatten(tree)
    want = jax.tree.leaves(tree)
    assert len(leaves) == len(want)
    assert all(np.array_equal(a, b) for a, b in zip(leaves, want))
    back = tree_unflatten(treedef, leaves)
    assert jax.tree.structure(back) == jax.tree.structure(tree)


def test_map_of_several_trees_equals_jax_tree_map():
    a, b = _tree(1), _tree(2)
    got = tree_map(lambda x, y: x * 2 + y, a, b)
    want = jax.tree.map(lambda x, y: x * 2 + y, a, b)
    assert all(np.array_equal(x, y) for x, y in zip(tree_leaves(got), jax.tree.leaves(want)))
    assert jax.tree.structure(got) == jax.tree.structure(want)


def test_map_split_returns_one_tree_per_value():
    a = _tree(3)
    lo, hi = tree_map_split(lambda x: (x - 1, x + 1), 2, a)
    assert all(np.array_equal(x, y - 1) for x, y in zip(tree_leaves(lo), tree_leaves(a)))
    assert all(np.array_equal(x, y + 1) for x, y in zip(tree_leaves(hi), tree_leaves(a)))
    assert tree_flatten(lo)[1] == tree_flatten(a)[1] == tree_flatten(hi)[1]


def test_is_leaf_makes_tuples_leaves_as_jax_does():
    # The MoE's shapes and specs are tuples, leaves beside the parameters.
    shapes = {"router": (4, 8), "dense": {"w1": (4, 6), "w2": (6, 4)}}
    axes = {"router": ("fsdp", "experts"), "dense": {"w1": ("fsdp", "mlp"),
                                                     "w2": ("mlp", None)}}
    is_tuple = lambda x: isinstance(x, tuple)  # noqa: E731
    got = tree_map(lambda s, a: list(zip(a, s)), shapes, axes, is_leaf=is_tuple)
    want = jax.tree.map(lambda s, a: list(zip(a, s)), shapes, axes, is_leaf=is_tuple)
    assert got == want
    assert tree_leaves(shapes) == jax.tree.leaves(shapes) == [4, 6, 6, 4, 4, 8]
    assert tree_flatten(shapes, is_tuple)[0] == jax.tree.leaves(shapes, is_leaf=is_tuple)
    with pytest.raises(ValueError, match="structures differ"):
        tree_map(lambda s, a: s, shapes, {"router": axes["router"]}, is_leaf=is_tuple)


def test_namedtuple_states_keep_their_class():
    for cls in (AdamWState, AdafactorState):
        st = cls(torch.tensor(1), {"w": torch.ones(2)}, [torch.zeros(2)])
        back = tree_map(lambda t: t + 1, st)
        assert type(back) is cls and int(back.step) == 2
        assert isinstance(back[2], list)


def test_mismatched_structures_raise():
    with pytest.raises(ValueError, match="structures differ"):
        tree_map(lambda x, y: x + y, {"a": np.ones(1)}, {"b": np.ones(1)})
    with pytest.raises(ValueError, match="structures differ"):
        tree_map(lambda x, y: x + y, [np.ones(1)], (np.ones(1),))


def test_no_reference_cycle_keeps_leaves_alive():
    """A dropped leaf is freed at once, not at the collector's next pass:
    an optimizer maps over every leaf of a model each step."""
    gc.collect()
    gc.disable()
    try:
        leaf = torch.zeros(3)
        ref = weakref.ref(leaf)
        tree_unflatten(tree_flatten({"a": [0, 0]})[1], [leaf, torch.ones(1)])
        tree_map_split(lambda x: (x + 1, x), 2, {"w": [leaf]})
        del leaf
        assert ref() is None
    finally:
        gc.enable()
