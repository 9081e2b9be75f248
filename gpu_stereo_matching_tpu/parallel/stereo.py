"""Distributed block matching over a (data, space, disp) mesh.

Strategy (SURVEY §2.5):

* ``data``  — frames of the batch are independent (pure DP),
* ``space`` — the image H axis is tiled; SAD windows need ``radius`` rows
  from each neighbor, supplied by ring halo exchange (``ppermute``, which
  XLA hands to NCCL) with zeros at the global borders → bit-identical to
  the single-device clipped-window pipeline,
* ``disp``  — each shard evaluates a contiguous disparity range; the WTA
  argmin becomes a packed-key ``pmin`` over the axis
  (key = SAD·D + d, so ties still resolve to the smallest global d).

The whole step is one ``shard_map``-wrapped jitted function; XLA inserts
the collectives.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from gpu_stereo_matching_tpu.core.config import BlockMatchingConfig
from gpu_stereo_matching_tpu.models.block_matching import sad_wta_keys
from gpu_stereo_matching_tpu.ops.aggregate import aggregate_cost_volume
from gpu_stereo_matching_tpu.ops.cost import ad_cost_volume_offset
from gpu_stereo_matching_tpu.parallel.halo import extend_with_row_halos


def make_sharded_block_matching(
    mesh: Mesh,
    config: BlockMatchingConfig,
    interpret: bool = False,
):
    """Build a jitted (B, H, W)×2 → (B, H, W) sharded disparity step.

    Inputs are uint8 gray batches sharded ``P('data', 'space', None)``;
    output disparities have the same sharding (replicated over ``disp``).
    Each shard's partial-range WTA runs through the fused kernel on the GPU
    and through the XLA ops path on other platforms; ``interpret`` runs the
    kernel in the Pallas interpreter instead (CPU tests of the kernel path).
    """
    num_d = config.num_disparities
    n_disp_shards = mesh.shape["disp"]
    if num_d % n_disp_shards:
        raise ValueError("num_disparities must divide evenly over the disp axis")
    d_per_shard = num_d // n_disp_shards
    radius = config.sad_radius

    def local_step(left, right):  # (Bl, Hl, W) uint8 shards
        lex = extend_with_row_halos(left, radius, "space")
        rex = extend_with_row_halos(right, radius, "space")
        d0 = lax.axis_index("disp") * d_per_shard
        key = sad_wta_keys(
            lex, rex, d0, d_per_shard, num_d, radius,
            int(config.invalid_cost), interpret,
        )
        if radius > 0:
            key = key[:, radius:-radius, :]
        key = lax.pmin(key, "disp")
        return (key % num_d).astype(jnp.int32)

    sharded = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P("data", "space", None), P("data", "space", None)),
        out_specs=P("data", "space", None),
        check_vma=False,
    )
    return jax.jit(sharded)


def make_sharded_block_matching_full(mesh: Mesh, config: BlockMatchingConfig):
    """Sharded config-2 pipeline: SAD + WTA + LR consistency + median.

    Bit-identical to ``block_matching_pipeline`` with
    ``lr_consistency=True, median_radius=config.median_radius``: the halo
    covers the chained windows (SAD radius + median radius), both views'
    WTA reduce over the ``disp`` axis as packed-key ``pmin``s, and the
    median excludes rows past the global image border via a validity mask
    (so global edges keep exact clipped-window semantics).
    """
    num_d = config.num_disparities
    n_disp_shards = mesh.shape["disp"]
    if num_d % n_disp_shards:
        raise ValueError("num_disparities must divide evenly over the disp axis")
    d_per_shard = num_d // n_disp_shards
    sad_r = config.sad_radius
    med_r = config.median_radius
    halo = sad_r + med_r
    n_space = mesh.shape["space"]

    from gpu_stereo_matching_tpu.ops.postprocess import (
        lr_consistency_mask,
        median_filter_u8,
    )

    def local_step(left, right):  # (Bl, Hl, W) uint8 shards
        h_local = left.shape[1]
        h_global = h_local * n_space
        lex = extend_with_row_halos(left, halo, "space")
        rex = extend_with_row_halos(right, halo, "space")
        d0 = lax.axis_index("disp") * d_per_shard
        space_idx = lax.axis_index("space")
        # Validity of slab rows w.r.t. the global image extent.
        slab_rows = h_local + 2 * halo
        row_ids = jnp.arange(slab_rows)
        global_row = space_idx * h_local + (row_ids - halo)
        row_valid = (global_row >= 0) & (global_row < h_global)

        def per_frame(lf, rf):
            vol = ad_cost_volume_offset(
                lf, rf, d_per_shard, d0, int(config.invalid_cost)
            )
            sad = aggregate_cost_volume(vol, sad_r)  # (dl, slab, W) int32
            d_ids = (d0 + jnp.arange(d_per_shard, dtype=jnp.int32))[:, None, None]
            key_l = jnp.min(sad * num_d + d_ids, axis=0)
            # Right-view SAD: right(d,y,x) = left(d,y,x+d), invalid → max.
            w = sad.shape[-1]
            x = jnp.arange(w)
            src = jnp.clip(x[None, :] + d0 + jnp.arange(d_per_shard)[:, None], 0, w - 1)
            gathered = jnp.take_along_axis(
                sad, jnp.broadcast_to(src[:, None, :], sad.shape), axis=-1
            )
            in_r = (x[None, :] + d0 + jnp.arange(d_per_shard)[:, None]) <= w - 1
            key_r_vol = jnp.where(
                in_r[:, None, :],
                gathered * num_d + d_ids,
                jnp.iinfo(jnp.int32).max,  # packed AFTER the key to avoid overflow
            )
            key_r = jnp.min(key_r_vol, axis=0)
            return key_l, key_r

        key_l, key_r = jax.vmap(per_frame)(lex, rex)
        key_l = lax.pmin(key_l, "disp")
        key_r = lax.pmin(key_r, "disp")
        disp_l = (key_l % num_d).astype(jnp.int32)
        disp_r = (key_r % num_d).astype(jnp.int32)

        def post(dl, dr):
            mask = lr_consistency_mask(dl, dr, config.lr_max_diff)
            dl = jnp.where(mask, dl, 0)
            if med_r > 0:
                valid2d = jnp.broadcast_to(row_valid[:, None], dl.shape)
                dl = median_filter_u8(
                    dl.astype(jnp.uint8), med_r, method="sort",
                    valid_mask=valid2d,
                ).astype(jnp.int32)
            return dl

        out = jax.vmap(post)(disp_l, disp_r)
        return out[:, halo : halo + h_local, :]

    sharded = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P("data", "space", None), P("data", "space", None)),
        out_specs=P("data", "space", None),
        check_vma=False,
    )
    return jax.jit(sharded)


def shard_batch(mesh: Mesh, left: jnp.ndarray, right: jnp.ndarray):
    """Place a (B, H, W) stereo batch with the step's input sharding."""
    sharding = NamedSharding(mesh, P("data", "space", None))
    return jax.device_put(left, sharding), jax.device_put(right, sharding)
