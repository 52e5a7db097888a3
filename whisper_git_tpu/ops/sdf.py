"""Signed-distance-field generation — exact Euclidean distance transform
(JAX).

The reference builds its font atlas by rasterizing glyphs with fontdue and
running a custom EDT over the coverage bitmap (reference: README "SDF text
rendering … custom EDT pipeline"; docs/render_engine.md TextRenderer). Our
accelerator-native formulation is the classic two-phase EDT with both
phases vectorized:

  phase 1 — per-row nearest-seed distance via two `cummax` scans
            (O(n), no sequential Python, compiles to a handful of ops);
  phase 2 — exact column mixing as a min-plus reduction:
            D²[i,j] = min_i' ( (i-i')² + dx[i',j]² ),
            a (H,H,W) broadcast-min that XLA fuses whole.

This is exact (not an approximation like chamfer/JFA) and compiles in
milliseconds where a 48-stage jump-flood roll chain took XLA a minute.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_BIG = 1e6  # larger than any atlas dimension; squares stay finite in f32


def _row_dist(is_seed: jnp.ndarray) -> jnp.ndarray:
    """Per-row distance (in columns) to the nearest seed in the same row.
    (H, W) bool → (H, W) float32; rows without seeds get _BIG."""
    H, W = is_seed.shape
    j = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)
    left = jax.lax.cummax(jnp.where(is_seed, j, -_BIG), axis=1)
    right = jax.lax.cummin(jnp.where(is_seed, j, _BIG), axis=1, reverse=True)
    return jnp.minimum(j - left, right - j)


_ROW_BLOCK = 16


def _edt(is_seed: jnp.ndarray) -> jnp.ndarray:
    """Exact Euclidean distance to the nearest seed. (H, W) bool → float32.

    The (H, H, W) min-plus intermediate is chunked over _ROW_BLOCK output
    rows (lax.map) so peak memory stays at BLOCK·H·W instead of H²·W."""
    H, W = is_seed.shape
    dx2 = jnp.minimum(_row_dist(is_seed), _BIG) ** 2      # (H, W)
    ip = jax.lax.broadcasted_iota(jnp.float32, (1, H), 1)  # source rows

    block = min(_ROW_BLOCK, H)
    n_blocks = -(-H // block)
    pad_h = n_blocks * block

    def row_block(b):
        i = (b * block + jax.lax.broadcasted_iota(jnp.int32, (block, 1), 0)
             ).astype(jnp.float32)                        # (block, 1)
        di2 = (i - ip) ** 2                               # (block, H)
        return jnp.min(di2[:, :, None] + dx2[None, :, :], axis=1)  # (block, W)

    d2 = jax.lax.map(row_block, jnp.arange(n_blocks))      # (n_blocks, block, W)
    d2 = d2.reshape(pad_h, W)[:H]
    return jnp.sqrt(d2)


@functools.partial(jax.jit, static_argnames=("max_dist",))
def signed_distance_field(coverage: jnp.ndarray, max_dist: float = 16.0
                          ) -> jnp.ndarray:
    """coverage: (H, W) float32 in [0,1] → signed distance (H, W) float32,
    positive outside the glyph, negative inside, clamped to ±max_dist."""
    return _sdf_impl(coverage, max_dist)


@functools.partial(jax.jit, static_argnames=("max_dist",))
def signed_distance_field_batch(coverage: jnp.ndarray, max_dist: float = 16.0
                                ) -> jnp.ndarray:
    """(B, H, W) → (B, H, W): all glyph cells in one dispatch. Sequential
    over cells (lax.map) — each cell already parallelizes internally, and
    this keeps atlas-build memory flat."""
    return jax.lax.map(
        lambda c: _sdf_impl(c, max_dist), coverage)


def _sdf_impl(coverage: jnp.ndarray, max_dist: float) -> jnp.ndarray:
    inside = coverage > 0.5
    d_to_glyph = _edt(inside)
    d_to_bg = _edt(~inside)
    sdf = jnp.where(inside, -(d_to_bg - 0.5), d_to_glyph - 0.5)
    return jnp.clip(sdf, -max_dist, max_dist)


def sdf_to_u8(sdf: jnp.ndarray, spread: float = 8.0) -> jnp.ndarray:
    """Encode an SDF into the u8 atlas format (128 = edge, like the
    reference's R8_UNORM atlas): value = 128 - sdf * (128/spread)."""
    enc = 128.0 - sdf * (128.0 / spread)
    return jnp.clip(enc, 0.0, 255.0).astype(jnp.uint8)


def u8_to_sdf(u8: jnp.ndarray, spread: float = 8.0) -> jnp.ndarray:
    return (128.0 - u8.astype(jnp.float32)) * (spread / 128.0)
