"""Non-local segment-tree cost aggregation as parallel level scans.

The reference filter (``STMatching/SegmentTree.cpp:148-181``) is two strictly
sequential passes over the BFS array:

* leaf→root:  ``buf[parent(v)] += w(v) · buf[v]``  (children before parents)
* root→leaf:  ``final[v] = w(v)·(final[parent(v)] − w(v)·buf[v]) + buf[v]``

The data-parallel reformulation exploits that nodes of one BFS depth have no
ancestor/descendant relations: each pass becomes a ``lax.scan`` over depths
where every step is a fully vectorized segment scatter-add (upward) or
gather (downward) over all nodes of that depth × all disparity channels.
Depth-padded index matrices are precomputed on the host from the C++
builder's level offsets; a dummy slot (index N) absorbs padding lanes.

Exact — same arithmetic as the sequential passes, reordered only across
commutative additions.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from gpu_stereo_matching_tpu.tree.builder import SegmentTree


@dataclasses.dataclass(frozen=True)
class TreeFilterPlan:
    """Device-ready level-scan plan for one segment tree."""

    num_nodes: int
    level_idx: jnp.ndarray     # (L-1, Wmax) int32 node ids, depth 1.. ; pad = N
    parent_idx: jnp.ndarray    # (L-1, Wmax) int32 parent ids; pad = N
    parent_w: jnp.ndarray      # (L-1, Wmax) f32 edge weights; pad = 0

    @staticmethod
    def from_tree(tree: SegmentTree, sigma: float) -> "TreeFilterPlan":
        n = tree.num_nodes
        weights = tree.parent_weights(sigma)
        starts = tree.level_start
        num_levels = tree.num_levels
        widths = np.diff(starts)[1:]  # per-depth node counts, depth >= 1
        wmax = int(widths.max()) if len(widths) else 1
        li = np.full((max(num_levels - 1, 1), wmax), n, np.int32)
        pi = np.full_like(li, n)
        pw = np.zeros(li.shape, np.float32)
        for l in range(1, num_levels):
            nodes = tree.bfs_order[starts[l] : starts[l + 1]]
            li[l - 1, : len(nodes)] = nodes
            pi[l - 1, : len(nodes)] = tree.parent[nodes]
            pw[l - 1, : len(nodes)] = weights[nodes]
        return TreeFilterPlan(
            num_nodes=n,
            level_idx=jnp.asarray(li),
            parent_idx=jnp.asarray(pi),
            parent_w=jnp.asarray(pw),
        )


def tree_filter_nodes(cost_nodes: jnp.ndarray, plan: TreeFilterPlan) -> jnp.ndarray:
    """Aggregate (N, D) node-major costs over the tree → (N, D)."""
    n = plan.num_nodes
    pad = jnp.zeros((1, cost_nodes.shape[1]), cost_nodes.dtype)
    buf = jnp.concatenate([cost_nodes, pad], axis=0)  # (N+1, D)

    def up(buf, level):
        idx, par, w = level
        vals = buf[idx] * w[:, None]
        return buf.at[par].add(vals), None

    # leaf → root: deepest level first.
    levels_rev = (
        plan.level_idx[::-1],
        plan.parent_idx[::-1],
        plan.parent_w[::-1],
    )
    buf, _ = jax.lax.scan(up, buf, levels_rev)

    def down(final, level):
        idx, par, w = level
        wv = w[:, None]
        newv = wv * (final[par] - wv * buf[idx]) + buf[idx]
        return final.at[idx].set(newv), None

    final, _ = jax.lax.scan(
        down, buf, (plan.level_idx, plan.parent_idx, plan.parent_w)
    )
    return final[:n]


def tree_filter(
    cost_volume: jnp.ndarray,
    tree: SegmentTree,
    sigma: float,
) -> jnp.ndarray:
    """Aggregate a (D, H, W) cost volume over ``tree`` → (D, H, W).

    Convenience wrapper: builds the level plan on the host, runs the jitted
    scans on device. Pipelines that reuse one tree across many volumes
    should build a :class:`TreeFilterPlan` once and call the jitted
    :func:`tree_filter_nodes` directly.
    """
    d, h, w = cost_volume.shape
    plan = TreeFilterPlan.from_tree(tree, sigma)
    nodes = jnp.moveaxis(cost_volume, 0, -1).reshape(h * w, d)
    out = _tree_filter_nodes_jit(nodes, plan)
    return jnp.moveaxis(out.reshape(h, w, d), -1, 0)


@jax.jit
def _tree_filter_nodes_jit(cost_nodes, plan):
    return tree_filter_nodes(cost_nodes, plan)


jax.tree_util.register_pytree_node(
    TreeFilterPlan,
    lambda p: ((p.level_idx, p.parent_idx, p.parent_w), p.num_nodes),
    lambda n, ch: TreeFilterPlan(n, *ch),
)
