"""Fused SAD + WTA block-matching kernel (Pallas through Triton, for Hopper).

This replaces the reference's two-kernel hot path — ``kernalPreCal_V2``
(per-(pixel, d) abs-diff volume in global memory,
``BlockMatching/Device.cu:19-32``) and ``kernalFindCorr`` (one thread per
pixel with an O(d·w²) window loop, ``Device.cu:34-64``) — with one kernel
that never writes a cost volume: each program reads the two u8 images and
writes one int32 per pixel.

Layout of one program (``block_d`` disparities × ``block_w`` columns):

* the program owns a strip of ``block_w`` output columns and a chunk of
  ``block_rows`` output rows of one frame, for ``block_d`` consecutive
  disparities; blocks share nothing and run in any order;
* it walks its rows top to bottom keeping, per (d, column), the vertical
  window sum of ``e(y, x) = diff(y, x + r) - diff(y, x - r - 1)`` — adding
  the row entering the window and subtracting the one leaving it, so the
  vertical (2r+1)-row sum costs O(1) per row;
* the horizontal window sum is then a prefix sum of that difference along
  the strip (``cumsum``, a Triton scan) plus the window sum of the column
  left of the strip, which is carried the same way (``init`` below). Triton
  cannot shift a register block, so both sliding sums are built from
  values loaded at already-shifted addresses, which L1/L2 serve;
* the WTA is a ``min`` over the disparity axis of the packed key
  ``SAD·total_d + d``, so ties go to the smallest d (the reference's strict
  ``<`` on an ascending scan) and disparity chunks or shards combine with a
  plain ``min``.

Semantics are exactly those of the XLA ops path
(``ops.ad_cost_volume`` → ``ops.aggregate_cost_volume`` →
``ops.wta_disparity``): windows are clipped at the image border, in-image
columns ``x < d`` cost 255 (``BlockMatching.cpp:208-212``). All arithmetic
is int32, so the SAD values — not only the argmin — are bit-identical.

Masked loads replace host-side padding: no input is copied before the call.
``interpret=True`` runs the Pallas interpreter (how the CPU tests reach the
kernel); without it the kernel only lowers for CUDA, and any other backend
raises.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from gpu_stereo_matching_tpu.core.validation import check_gray_pair

INVALID_COST = 255
_INT32_MAX = jnp.iinfo(jnp.int32).max


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _kernel(
    d0_ref,     # (1,) int32: first disparity of the evaluated range
    left_ref,   # (B, H, W) uint8
    right_ref,  # (B, H, W) uint8
    out_ref,    # (n_chunks, B, H, W) int32 keys, or (B, H, W) disparities
    *,
    count: int,
    total: int,
    radius: int,
    block_d: int,
    block_w: int,
    block_rows: int,
    emit_disparity: bool,
):
    _, h, w = left_ref.shape
    r = radius
    k = 2 * r + 1
    kp = _pow2_at_least(k)
    n_chunks = pl.num_programs(2) // left_ref.shape[0]

    y0 = pl.program_id(0) * block_rows
    x0 = pl.program_id(1) * block_w
    b = pl.program_id(2) // n_chunks
    chunk = pl.program_id(2) % n_chunks

    d_local = chunk * block_d + jnp.arange(block_d, dtype=jnp.int32)
    d_ok = d_local < count
    d = d0_ref[0] + d_local                                  # (Dc,)
    j = jnp.arange(block_w, dtype=jnp.int32)
    cols_p = x0 + j + r                                      # entering column
    cols_q = x0 + j - r - 1                                  # leaving column
    t = jnp.arange(kp, dtype=jnp.int32)
    cols_i = x0 - 1 - r + t                                  # window of x0-1
    in_win = t < k

    def diff(row, cols, col_mask=None):
        """Clipped AD cost |L(row, c) - R(row, c - d)| → (Dc, n) int32.

        0 outside the image (clipped windows), 255 for in-image c < d."""
        row_ok = (row >= 0) & (row < h)
        col_ok = (cols >= 0) & (cols < w)
        if col_mask is not None:
            col_ok = col_ok & col_mask
        src = cols[None, :] - d[:, None]
        lv = plgpu.load(left_ref.at[b, row, cols], mask=row_ok & col_ok, other=0)
        rv = plgpu.load(
            right_ref.at[b, row, src],
            mask=row_ok & col_ok[None, :] & (src >= 0),
            other=0,
        )
        ad = jnp.abs(lv.astype(jnp.int32)[None, :] - rv.astype(jnp.int32))
        ad = jnp.where(src < 0, INVALID_COST, ad)
        return jnp.where(row_ok & col_ok[None, :], ad, 0)

    def edge(row):
        # e(row, x) and the left-of-strip window sum for one image row.
        e = diff(row, cols_p) - diff(row, cols_q)
        s = jnp.sum(diff(row, cols_i, in_win), axis=1)
        return e, s

    def warm(i, carry):
        e_acc, s_acc = carry
        e, s = edge(y0 - r - 1 + i)
        return e_acc + e, s_acc + s

    zeros = (
        jnp.zeros((block_d, block_w), jnp.int32),
        jnp.zeros((block_d,), jnp.int32),
    )
    # Rows y0-r-1 .. y0+r-1: the window of output row y0-1, so each output
    # row below adds one row and drops one.
    carry = jax.lax.fori_loop(0, k, warm, zeros)

    col_out = x0 + j
    col_store = col_out < w

    def step(i, carry):
        e_acc, s_acc = carry
        y = y0 + i
        e_in, s_in = edge(y + r)
        e_out, s_out = edge(y - r - 1)
        e_acc = e_acc + e_in - e_out
        s_acc = s_acc + s_in - s_out
        sad = s_acc[:, None] + jnp.cumsum(e_acc, axis=1)
        key = jnp.where(d_ok[:, None], sad * total + d[:, None], _INT32_MAX)
        best = jnp.min(key, axis=0)
        mask = col_store & (y < h)
        if emit_disparity:
            plgpu.store(out_ref.at[b, y, col_out], best % total, mask=mask)
        else:
            plgpu.store(out_ref.at[chunk, b, y, col_out], best, mask=mask)
        return e_acc, s_acc

    jax.lax.fori_loop(0, block_rows, step, carry)


@functools.partial(
    jax.jit,
    static_argnames=(
        "count", "total_disparities", "radius", "emit_disparity", "interpret",
        "block_d", "block_w", "block_rows", "num_warps",
    ),
)
def _sad_wta_call(
    left, right, d_start, *, count, total_disparities, radius, emit_disparity,
    interpret, block_d, block_w, block_rows, num_warps,
):
    bsz, h, w = left.shape
    block_d = min(block_d, _pow2_at_least(count))
    n_chunks = -(-count // block_d)
    if emit_disparity and n_chunks > 1:
        raise ValueError("emit_disparity needs the range in one chunk")
    # Keys must not overflow int32: SAD ≤ 255·(2r+1)².
    if INVALID_COST * (2 * radius + 1) ** 2 * total_disparities + total_disparities >= 2**31:
        raise ValueError("radius × disparity count overflows the int32 key")
    if emit_disparity:
        out_shape = jax.ShapeDtypeStruct((bsz, h, w), jnp.int32)
    else:
        out_shape = jax.ShapeDtypeStruct((n_chunks, bsz, h, w), jnp.int32)
    kernel = functools.partial(
        _kernel,
        count=count, total=total_disparities, radius=radius, block_d=block_d,
        block_w=block_w, block_rows=block_rows, emit_disparity=emit_disparity,
    )
    any_spec = pl.BlockSpec(memory_space=pl.ANY)
    d0 = jnp.asarray(d_start, jnp.int32).reshape(1)
    out = pl.pallas_call(
        kernel,
        grid=(-(-h // block_rows), -(-w // block_w), bsz * n_chunks),
        in_specs=[any_spec, any_spec, any_spec],
        out_specs=any_spec,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="sad_wta",
    )(d0, left, right)
    return out if emit_disparity else jnp.min(out, axis=0)


# Tile defaults for the H100 (see PERF.md, "Kernel decisions").
TILES = dict(block_d=64, block_w=16, block_rows=64, num_warps=4)


def fused_block_matching_key(
    left_gray: jnp.ndarray,
    right_gray: jnp.ndarray,
    d_start,
    count: int,
    total_disparities: int,
    radius: int = 5,
    interpret: bool = False,
    **tiles,
) -> jnp.ndarray:
    """Packed WTA keys over disparities ``d_start .. d_start+count-1``.

    Returns ``min_d SAD(d)·total_disparities + d`` per pixel, (H, W) or
    (B, H, W) int32 like the inputs. ``d_start`` may be traced (a mesh-axis
    index): the ``min`` of the keys of disjoint ranges is the key of their
    union, with ties still going to the smallest global d.
    """
    check_gray_pair(left_gray, right_gray, total_disparities, "sad_wta_key")
    squeeze = left_gray.ndim == 2
    if squeeze:
        left_gray, right_gray = left_gray[None], right_gray[None]
    out = _sad_wta_call(
        left_gray, right_gray, d_start, count=count,
        total_disparities=total_disparities, radius=radius,
        emit_disparity=False, interpret=interpret, **{**TILES, **tiles},
    )
    return out[0] if squeeze else out


def fused_block_matching(
    left_gray: jnp.ndarray,
    right_gray: jnp.ndarray,
    num_disparities: int = 64,
    radius: int = 5,
    interpret: bool = False,
    **tiles,
) -> jnp.ndarray:
    """Disparity of (H, W) or (B, H, W) uint8 pairs → int32 of that shape.

    Bit-identical to ``models.block_matching.block_matching_disparity`` with
    no LR check and no median.
    """
    check_gray_pair(left_gray, right_gray, num_disparities, "sad_wta")
    squeeze = left_gray.ndim == 2
    if squeeze:
        left_gray, right_gray = left_gray[None], right_gray[None]
    t = {**TILES, **tiles}
    one_chunk = num_disparities <= t["block_d"]
    out = _sad_wta_call(
        left_gray, right_gray, 0, count=num_disparities,
        total_disparities=num_disparities, radius=radius,
        emit_disparity=one_chunk, interpret=interpret, **t,
    )
    if not one_chunk:
        out = out % num_disparities
    return out[0] if squeeze else out
