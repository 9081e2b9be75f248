"""Segment-tree builder (C++ vs NumPy twin) and device tree filter vs oracle."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gpu_stereo_matching_tpu.tree.builder import (
    build_segment_tree,
    build_segment_tree_py,
    color_edge_weights,
    grid_edges,
)
from gpu_stereo_matching_tpu.tree.filter import tree_filter
from tests import oracles


def _random_weights(rng, h, w):
    ea, eb = grid_edges(h, w)
    return (rng.random(len(ea)) * 60).astype(np.float32)


def _check_tree_invariants(t, h, w):
    n = h * w
    assert sorted(t.bfs_order.tolist()) == list(range(n))
    assert sorted(t.dfs_order.tolist()) == list(range(n))
    assert t.parent[0] == 0 and t.level_of[0] == 0
    # children appear after parents in BFS order; levels consistent
    pos = np.empty(n, np.int64)
    pos[t.bfs_order] = np.arange(n)
    for v in range(1, n):
        assert pos[t.parent[v]] < pos[v]
        assert t.level_of[v] == t.level_of[t.parent[v]] + 1
    # level_start consistent with level_of
    counts = np.bincount(t.level_of, minlength=t.num_levels)
    np.testing.assert_array_equal(np.diff(t.level_start), counts)
    # subtree sizes: root covers all
    assert t.subtree_size[0] == n
    # edges connect grid neighbors
    for v in range(1, n):
        p = int(t.parent[v])
        dy = abs(v // w - p // w)
        dx = abs(v % w - p % w)
        assert dy + dx == 1


def test_grid_edges_count():
    ea, eb = grid_edges(5, 7)
    assert len(ea) == 2 * 5 * 7 - 5 - 7


@pytest.mark.parametrize("hw", [(6, 9), (11, 8)])
def test_cpp_vs_numpy_builder(rng, hw):
    h, w = hw
    weights = _random_weights(rng, h, w)
    tc = build_segment_tree(weights, h, w, tau=80.0, min_size=4, penalty=5.0)
    tp = build_segment_tree_py(weights, h, w, tau=80.0, min_size=4, penalty=5.0)
    _check_tree_invariants(tc, h, w)
    _check_tree_invariants(tp, h, w)
    # Traversal-order-independent structure must agree exactly.
    np.testing.assert_array_equal(tc.parent, tp.parent)
    np.testing.assert_array_equal(tc.parent_dist, tp.parent_dist)
    np.testing.assert_array_equal(tc.level_of, tp.level_of)
    np.testing.assert_array_equal(tc.subtree_size, tp.subtree_size)


def test_color_weights(rng):
    img = rng.integers(0, 256, size=(7, 9, 3), dtype=np.uint8)
    wts = color_edge_weights(img, presmooth=False)
    ea, eb = grid_edges(7, 9)
    flat = img.reshape(-1, 3).astype(np.int32)
    want = np.abs(flat[ea] - flat[eb]).max(axis=1).astype(np.float32)
    np.testing.assert_array_equal(wts, want)


def test_native_weight_providers_match_numpy(rng):
    """C++ weight providers are bit-identical to the NumPy/JAX oracles."""
    from gpu_stereo_matching_tpu.tree.builder import color_depth_edge_weights

    img = rng.integers(0, 256, size=(13, 17, 3), dtype=np.uint8)
    for presmooth in (False, True):
        native = color_edge_weights(img, presmooth=presmooth, native=True)
        oracle = color_edge_weights(img, presmooth=presmooth, native=False)
        np.testing.assert_array_equal(native, oracle)

    disp = rng.integers(0, 60, size=(13, 17)).astype(np.float32)
    stable = rng.random((13, 17)) > 0.4
    native = color_depth_edge_weights(img, disp, stable, 60, native=True)
    oracle = color_depth_edge_weights(img, disp, stable, 60, native=False)
    np.testing.assert_array_equal(native, oracle)


def test_native_hpd_plan_matches_numpy(rng):
    """The C++ HPD plan core emits the exact arrays of the NumPy builder."""
    from gpu_stereo_matching_tpu.tree.hpd import HeavyPathPlan

    h, w = 19, 23
    weights = _random_weights(rng, h, w)
    tree = build_segment_tree(weights, h, w, tau=80.0, min_size=4, penalty=5.0)
    native = HeavyPathPlan.from_tree(tree, 0.1, native=True)
    oracle = HeavyPathPlan.from_tree(tree, 0.1, native=False)
    assert native.rounds_meta == oracle.rounds_meta
    np.testing.assert_array_equal(np.asarray(native.ints), np.asarray(oracle.ints))
    np.testing.assert_array_equal(
        np.asarray(native.floats), np.asarray(oracle.floats)
    )


def test_tree_filter_matches_sequential_oracle(rng):
    h, w, d = 9, 12, 5
    weights = _random_weights(rng, h, w)
    tree = build_segment_tree(weights, h, w, tau=100.0, min_size=6, penalty=5.0)
    cost = rng.random((d, h, w)).astype(np.float32)

    got = np.asarray(tree_filter(jnp.asarray(cost), tree, sigma=0.1))

    nodes = np.moveaxis(cost, 0, -1).reshape(h * w, d)
    want_nodes = oracles.tree_filter_oracle(
        nodes, tree.bfs_order, tree.parent, tree.parent_weights(0.1)
    )
    want = np.moveaxis(want_nodes.reshape(h, w, d), -1, 0)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_tree_filter_uniform_weights_is_global_mean(rng):
    # With all distances 0 (single flat segment), every weight is 1 and the
    # filtered cost at every node equals the total sum over all nodes.
    h, w, d = 5, 6, 3
    weights = np.zeros(2 * h * w - h - w, np.float32)
    tree = build_segment_tree(weights, h, w, tau=1e9, min_size=1000, penalty=0.0)
    cost = rng.random((d, h, w)).astype(np.float32)
    got = np.asarray(tree_filter(jnp.asarray(cost), tree, sigma=0.1))
    want = cost.sum(axis=(1, 2), keepdims=True) * np.ones_like(cost)
    np.testing.assert_allclose(got, want, rtol=1e-4)


class TestHeavyPathFilter:
    def _filter_hpd(self, cost, tree, sigma):
        import jax.numpy as jnp

        from gpu_stereo_matching_tpu.tree.hpd import (
            HeavyPathPlan,
            tree_filter_nodes_hpd,
        )

        d, h, w = cost.shape
        plan = HeavyPathPlan.from_tree(tree, sigma)
        nodes = jnp.asarray(np.moveaxis(cost, 0, -1).reshape(h * w, d))
        out = np.asarray(tree_filter_nodes_hpd(nodes, plan))
        return np.moveaxis(out.reshape(h, w, d), -1, 0)

    @pytest.mark.parametrize("hw", [(7, 9), (12, 11), (1, 17), (16, 1)])
    def test_matches_sequential_oracle(self, rng, hw):
        h, w = hw
        weights = _random_weights(rng, h, w)
        tree = build_segment_tree(weights, h, w, tau=100.0, min_size=6, penalty=5.0)
        cost = rng.random((4, h, w)).astype(np.float32)
        got = self._filter_hpd(cost, tree, sigma=0.1)

        nodes = np.moveaxis(cost, 0, -1).reshape(h * w, 4)
        want_nodes = oracles.tree_filter_oracle(
            nodes, tree.bfs_order, tree.parent, tree.parent_weights(0.1)
        )
        want = np.moveaxis(want_nodes.reshape(h, w, 4), -1, 0)
        np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)

    def test_matches_level_filter_large(self, rng):
        h, w = 40, 37
        weights = _random_weights(rng, h, w)
        tree = build_segment_tree(weights, h, w, tau=300.0, min_size=20, penalty=5.0)
        cost = rng.random((8, h, w)).astype(np.float32)
        got = self._filter_hpd(cost, tree, sigma=0.08)
        want = np.asarray(tree_filter(jnp.asarray(cost), tree, sigma=0.08))
        np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)


class TestPlanOrderFilter:
    """Scatter-free plan-order formulation (tree/hpd.py PlanOrderPlan)."""

    def _tree(self, rng, h, w):
        weights = _random_weights(rng, h, w)
        return build_segment_tree(weights, h, w, tau=100.0, min_size=6,
                                  penalty=5.0)

    @pytest.mark.parametrize("hw", [(7, 9), (16, 21), (1, 8)])
    def test_matches_hpd_filter(self, rng, hw):
        from gpu_stereo_matching_tpu.tree.hpd import (
            HeavyPathPlan,
            PlanOrderPlan,
            tree_filter_nodes_hpd,
            tree_filter_nodes_po,
        )

        h, w = hw
        tree = self._tree(rng, h, w)
        cost = rng.random((h * w, 6)).astype(np.float32)
        old = np.asarray(
            tree_filter_nodes_hpd(
                jnp.asarray(cost), HeavyPathPlan.from_tree(tree, 0.1)
            )
        )
        new = np.asarray(
            tree_filter_nodes_po(
                jnp.asarray(cost), PlanOrderPlan.from_tree(tree, 0.1)
            )
        )
        np.testing.assert_allclose(new, old, rtol=2e-6, atol=2e-6)

    def test_matches_sequential_oracle(self, rng):
        from gpu_stereo_matching_tpu.tree.hpd import (
            PlanOrderPlan,
            tree_filter_nodes_po,
        )

        h, w, d = 11, 13, 5
        tree = self._tree(rng, h, w)
        cost = rng.random((h * w, d)).astype(np.float32)
        got = np.asarray(
            tree_filter_nodes_po(
                jnp.asarray(cost), PlanOrderPlan.from_tree(tree, 0.1)
            )
        )
        want = oracles.tree_filter_oracle(
            cost, tree.bfs_order, tree.parent, tree.parent_weights(0.1)
        )
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)

    def test_native_plan_matches_numpy_plan(self, rng):
        from gpu_stereo_matching_tpu.tree.hpd import PlanOrderPlan

        tree = self._tree(rng, 14, 19)
        native = PlanOrderPlan.from_tree(tree, 0.1, native=True)
        oracle = PlanOrderPlan.from_tree(tree, 0.1, native=False)
        assert native.rounds_meta == oracle.rounds_meta
        np.testing.assert_array_equal(
            np.asarray(native.ints), np.asarray(oracle.ints)
        )
        np.testing.assert_array_equal(
            np.asarray(native.floats), np.asarray(oracle.floats)
        )

    def test_batched_matches_single(self, rng):
        """vmap over stacked plans is bit-identical to per-frame filtering
        (the property the scatter-based formulation lacked)."""
        from gpu_stereo_matching_tpu.tree.hpd import (
            PlanOrderPlan,
            converged_plan_batch,
            tree_filter_nodes_po,
            tree_filter_nodes_po_batched,
        )

        h, w, d, b = 12, 15, 7, 3
        trees = [self._tree(rng, h, w) for _ in range(b)]
        costs = np.stack(
            [rng.random((h * w, d)).astype(np.float32) for _ in range(b)]
        )
        batch = converged_plan_batch(trees, 0.1)
        got = np.asarray(
            tree_filter_nodes_po_batched(jnp.asarray(costs), batch)
        )
        for i, t in enumerate(trees):
            single = np.asarray(
                tree_filter_nodes_po(
                    jnp.asarray(costs[i]), PlanOrderPlan.from_tree(t, 0.1)
                )
            )
            np.testing.assert_array_equal(got[i], single)

    @pytest.mark.parametrize("hw", [(7, 9), (16, 21), (1, 8), (23, 31)])
    def test_coded_matches_po_bitwise(self, rng, hw):
        """The u8-coded plan reproduces the plan-order filter EXACTLY —
        same gathers, same scan operands (tree/hpd.py CodedPlan)."""
        from gpu_stereo_matching_tpu.tree.hpd import (
            CodedPlan,
            PlanOrderPlan,
            tree_filter_nodes_po,
            tree_filter_nodes_po_coded,
        )

        h, w = hw
        tree = self._tree(rng, h, w)
        cost = rng.random((h * w, 6)).astype(np.float32)
        want = np.asarray(
            tree_filter_nodes_po(
                jnp.asarray(cost), PlanOrderPlan.from_tree(tree, 0.1)
            )
        )
        coded = CodedPlan.from_tree(tree, 0.1)
        got = np.asarray(
            tree_filter_nodes_po_coded(
                jnp.asarray(cost), coded, assoc_scan=True
            )
        )
        np.testing.assert_array_equal(got, want)
        # The default doubling scan reorders in-path summation; it must
        # still match to float tolerance.
        dbl = np.asarray(
            tree_filter_nodes_po_coded(jnp.asarray(cost), coded)
        )
        np.testing.assert_allclose(dbl, want, rtol=2e-6, atol=2e-6)

    def test_ints24_roundtrip(self, rng):
        """24-bit index packing is lossless and rejects out-of-range."""
        from gpu_stereo_matching_tpu.tree.hpd import (
            _unpack_ints24,
            pack_ints24,
        )

        vals = np.concatenate(
            [
                rng.integers(0, 1 << 24, 4096),
                np.array([0, 1, (1 << 24) - 1]),
            ]
        ).astype(np.int32)
        packed = pack_ints24(vals)
        assert packed.dtype == np.uint8 and packed.shape == (3, len(vals))
        np.testing.assert_array_equal(
            np.asarray(jax.jit(_unpack_ints24)(jnp.asarray(packed))), vals
        )
        with pytest.raises(ValueError):
            pack_ints24(np.array([1 << 24], dtype=np.int32))
        with pytest.raises(ValueError):
            # Negative indices would wrap through uint32 into valid-looking
            # 24-bit values — must be rejected, not packed.
            pack_ints24(np.array([-1], dtype=np.int32))

    def test_coded_fields_reconstruct_bitwise(self, rng):
        """Device-side field reconstruction from codes reproduces every
        float the uncoded plan carries, bit for bit."""
        from gpu_stereo_matching_tpu.tree.hpd import (
            CodedPlan,
            PlanOrderPlan,
            _reconstruct_po_fields,
            _unpack_po,
        )

        tree = self._tree(rng, 14, 19)
        plan = PlanOrderPlan.from_tree(tree, 0.1, device=False)
        coded = CodedPlan.from_tree(tree, 0.1, device=False)
        _w, heavy_a, down_a, omw2, head_w = jax.jit(_reconstruct_po_fields)(
            jnp.asarray(coded.codes), jnp.asarray(coded.table)
        )
        dev = PlanOrderPlan(
            plan.num_nodes, plan.total_pos, plan.rounds_meta,
            jnp.asarray(plan.ints), jnp.asarray(plan.floats),
        )
        rounds, offs, _perm, _inv = _unpack_po(dev)
        for off, (l, _k), (_hs, _ls, r_heavy, r_down, r_omw2, r_headw,
                           _lw) in zip(offs, plan.rounds_meta, rounds):
            np.testing.assert_array_equal(
                np.asarray(heavy_a[off : off + l]), np.asarray(r_heavy)
            )
            np.testing.assert_array_equal(
                np.asarray(down_a[off : off + l]), np.asarray(r_down)
            )
            np.testing.assert_array_equal(
                np.asarray(omw2[off : off + l]), np.asarray(r_omw2)
            )
            np.testing.assert_array_equal(
                np.asarray(head_w[off : off + l]), np.asarray(r_headw)
            )

    def test_seg_scan_cap_is_exact(self, rng):
        """Doubling steps beyond log2(max segment length) are mathematical
        no-ops when a == 0 at segment boundaries — the property that lets
        the filter cap its static step counts. In pure NumPy f32 the extra
        steps reproduce the capped result bit for bit; across two XLA
        programs fusion may differ by an ulp, so that path is gated at
        tight tolerance."""
        from gpu_stereo_matching_tpu.tree.hpd import _seg_scan

        l, d, seg = 256, 5, 16  # segments of length <= 16
        a = rng.uniform(0.1, 0.99, (l, 1)).astype(np.float32)
        a[::seg] = 0.0  # boundaries
        b = rng.standard_normal((l, d)).astype(np.float32)

        def np_scan(a, b, steps, reverse):
            a, b = a.copy(), b.copy()
            for k in range(steps):
                sh = 1 << k
                pa = np.ones((sh, 1), np.float32)
                pb = np.zeros((sh, d), np.float32)
                if reverse:
                    a_sh = np.concatenate([a[sh:], pa])
                    b_sh = np.concatenate([b[sh:], pb])
                else:
                    a_sh = np.concatenate([pa, a[:-sh]])
                    b_sh = np.concatenate([pb, b[:-sh]])
                b = b + a * b_sh
                a = a * a_sh
            return b

        for reverse in (False, True):
            aa = a if not reverse else a[::-1].copy()
            # bitwise no-op in a fixed arithmetic (NumPy f32)
            np.testing.assert_array_equal(
                np_scan(aa, b, 4, reverse), np_scan(aa, b, 8, reverse)
            )
            capped = np.asarray(
                jax.jit(_seg_scan, static_argnums=(2, 3))(
                    jnp.asarray(aa), jnp.asarray(b), 4, reverse
                )
            )
            full = np.asarray(
                jax.jit(_seg_scan, static_argnums=(2, 3))(
                    jnp.asarray(aa), jnp.asarray(b), 8, reverse
                )
            )
            np.testing.assert_allclose(capped, full, rtol=1e-6, atol=1e-7)

    def test_seg_scan_matches_associative_scan(self, rng):
        from gpu_stereo_matching_tpu.tree.hpd import _combine, _seg_scan

        l, d = 192, 4
        a = rng.uniform(0.0, 0.99, (l, 1)).astype(np.float32)
        a[rng.random(l) < 0.15] = 0.0
        b = rng.standard_normal((l, d)).astype(np.float32)
        got = np.asarray(
            jax.jit(_seg_scan, static_argnums=(2,))(
                jnp.asarray(a), jnp.asarray(b), 8
            )
        )
        want = np.asarray(
            jax.lax.associative_scan(
                _combine, (jnp.broadcast_to(jnp.asarray(a), (l, d)),
                           jnp.asarray(b)), axis=0
            )[1]
        )
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    def test_exact_lut(self):
        """The two-level one-hot LUT is exact for every code."""
        from gpu_stereo_matching_tpu.tree.hpd import _exact_lut, weight_lut

        table = weight_lut(0.1)
        got = np.asarray(
            jax.jit(_exact_lut)(
                jnp.arange(256, dtype=jnp.uint8), jnp.asarray(table)
            )
        )
        np.testing.assert_array_equal(got, table)

    def test_coded_batched_matches_single(self, rng):
        from gpu_stereo_matching_tpu.tree.hpd import (
            CodedPlan,
            stack_coded_plans,
            tree_filter_nodes_po_coded,
        )

        h, w, d, b = 12, 15, 7, 3
        trees = [self._tree(rng, h, w) for _ in range(b)]
        costs = np.stack(
            [rng.random((h * w, d)).astype(np.float32) for _ in range(b)]
        )
        plans = [CodedPlan.from_tree(t, 0.1, device=False) for t in trees]
        for _ in range(4):
            if len({p.layout_key for p in plans}) == 1:
                break
            plans = [CodedPlan.from_tree(t, 0.1, device=False) for t in trees]
        stacked = stack_coded_plans(plans)
        got = np.asarray(
            jax.vmap(tree_filter_nodes_po_coded, in_axes=(0, CodedPlan(
                stacked.num_nodes, stacked.total_pos, stacked.rounds_meta,
                0, 0, None, stacked.scan_steps, stacked.n_real,
            )))(jnp.asarray(costs), stacked)
        )
        for i, t in enumerate(trees):
            single = np.asarray(
                tree_filter_nodes_po_coded(
                    jnp.asarray(costs[i]), CodedPlan.from_tree(t, 0.1)
                )
            )
            np.testing.assert_array_equal(got[i], single)

    def test_stack_rejects_diverged_layouts(self, rng):
        from gpu_stereo_matching_tpu.tree.hpd import PlanOrderPlan, stack_plans

        t_a = self._tree(rng, 10, 11)
        t_b = self._tree(rng, 11, 10)  # different N layout key
        p_a = PlanOrderPlan.from_tree(t_a, 0.1)
        p_b = PlanOrderPlan.from_tree(t_b, 0.1)
        if p_a.rounds_meta != p_b.rounds_meta or p_a.total_pos != p_b.total_pos:
            with pytest.raises(ValueError):
                stack_plans([p_a, p_b])

    def test_merged_matches_single(self, rng):
        """The merged forest plan (one single-frame-shaped filter over
        B·N positions) is bit-identical to per-frame filtering for a
        power-of-two batch."""
        from gpu_stereo_matching_tpu.tree.hpd import (
            PlanOrderPlan,
            converged_plan_batch,
            merge_plans,
            tree_filter_nodes_po,
            tree_filter_nodes_po_merged,
        )

        h, w, d, b = 12, 15, 7, 4
        trees = [self._tree(rng, h, w) for _ in range(b)]
        costs = np.stack(
            [rng.random((h * w, d)).astype(np.float32) for _ in range(b)]
        )
        converged_plan_batch(trees, 0.1)  # converge the layout registry
        plans = [
            PlanOrderPlan.from_tree(t, 0.1, device=False) for t in trees
        ]
        merged = merge_plans(plans)
        got = np.asarray(
            tree_filter_nodes_po_merged(jnp.asarray(costs), merged)
        )
        for i, t in enumerate(trees):
            single = np.asarray(
                tree_filter_nodes_po(
                    jnp.asarray(costs[i]), PlanOrderPlan.from_tree(t, 0.1)
                )
            )
            np.testing.assert_array_equal(got[i], single)

    def test_merge_rejects_diverged_layouts(self, rng):
        from gpu_stereo_matching_tpu.tree.hpd import PlanOrderPlan, merge_plans

        t_a = self._tree(rng, 10, 11)
        t_b = self._tree(rng, 11, 10)
        p_a = PlanOrderPlan.from_tree(t_a, 0.1, device=False)
        p_b = PlanOrderPlan.from_tree(t_b, 0.1, device=False)
        if p_a.rounds_meta != p_b.rounds_meta or p_a.total_pos != p_b.total_pos:
            with pytest.raises(ValueError):
                merge_plans([p_a, p_b])
