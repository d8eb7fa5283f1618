"""Shared by the port's dense parity tests: the reference's parameter tree
with its vector leaves moved off their initial values.

The reference draws biases as zeros and norm scales as ones, so a bias
that is not added, or a norm that is not applied, shows only once these
leaves hold other values.
"""
import jax
import numpy as np

VECTOR_LEAVES = ("bq", "bk", "bv", "q_norm", "k_norm", "scale", "bias")


def perturb(tree, seed, names=VECTOR_LEAVES):
    """The reference tree with every leaf named in ``names`` (by default
    the vector leaves: biases, q/k norms, norm scales and biases) moved by
    0.1 N(0, 1) from its initial value."""
    rng = np.random.default_rng(seed)

    def one(path, leaf):
        name = str(getattr(path[-1], "key", ""))
        if name not in names:
            return leaf
        noise = rng.normal(size=leaf.shape).astype(np.float32)
        return (leaf + 0.1 * noise).astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(one, tree)
