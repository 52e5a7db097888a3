"""Image resize as separable matmuls (JAX).

The reference resizes avatars with Lanczos3 on the CPU (reference:
src/avatar.rs:191-198, image crate). The accelerator-native formulation
builds the two 1-D Lanczos sampling matrices on the host and applies them
as matmuls — the matrix units do the filtering, and a whole batch of avatars
resizes in one dispatch.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _lanczos_matrix(n_in: int, n_out: int, a: int = 3) -> np.ndarray:
    """(n_out, n_in) row-stochastic Lanczos-a sampling matrix."""
    scale = n_in / n_out
    support = a * max(scale, 1.0)
    x_out = (np.arange(n_out) + 0.5) * scale - 0.5
    idx = np.arange(n_in)
    dist = x_out[:, None] - idx[None, :]
    arg = dist / max(scale, 1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        lanc = np.sinc(arg) * np.sinc(arg / a)
    lanc = np.where(np.abs(arg) < a, lanc, 0.0)
    lanc = np.where(np.abs(dist) <= support, lanc, 0.0)
    s = lanc.sum(axis=1, keepdims=True)
    s[s == 0] = 1.0
    return (lanc / s).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _matrices(h_in: int, w_in: int, h_out: int, w_out: int
              ) -> tuple[jnp.ndarray, jnp.ndarray]:
    return (jnp.asarray(_lanczos_matrix(h_in, h_out)),
            jnp.asarray(_lanczos_matrix(w_in, w_out)))


@functools.partial(jax.jit, static_argnames=("h_out", "w_out"))
def _resize(imgs: jnp.ndarray, rows: jnp.ndarray, cols: jnp.ndarray,
            h_out: int, w_out: int) -> jnp.ndarray:
    x = imgs.astype(jnp.float32)
    # HIGHEST: on the GPU an f32 product defaults to TF32 (10-bit
    # mantissa, ~1e-3 relative per operand); an avatar resized here must
    # match the CPU render, and a once-per-avatar resize costs little.
    hi = jax.lax.Precision.HIGHEST
    # rows: (h_out, h_in) @ x: (B, h_in, w_in, C) along axis 1.
    x = jnp.einsum("oh,bhwc->bowc", rows, x,
                   preferred_element_type=jnp.float32, precision=hi)
    x = jnp.einsum("ow,bhwc->bhoc", cols, x,
                   preferred_element_type=jnp.float32, precision=hi)
    return x


def resize_lanczos(imgs, h_out: int, w_out: int) -> np.ndarray:
    """Resize a batch (B, H, W, C) of u8/float images to (B, h_out, w_out, C)
    with Lanczos3. Returns u8."""
    imgs = np.asarray(imgs)
    squeeze = imgs.ndim == 3
    if squeeze:
        imgs = imgs[None]
    B, H, W, C = imgs.shape
    rows, cols = _matrices(H, W, h_out, w_out)
    out = _resize(jnp.asarray(imgs), rows, cols, h_out, w_out)
    # round, don't truncate: plain u8 cast floors, biasing every
    # non-exact value ~0.5 levels dark across avatars/tiles.
    out = np.asarray(jnp.clip(jnp.round(out), 0, 255)).astype(np.uint8)
    return out[0] if squeeze else out
