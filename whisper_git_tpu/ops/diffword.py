"""Batched word-level diff highlight ranges (JAX).

The accelerator-batched analog of gitcore.diff.intra_line_highlight
(reference: src/git/diff.rs:135-250): given B paired (−,+) lines as padded
byte arrays, compute common-prefix/common-suffix lengths for all pairs at
once. Used by the diff viewer when a large diff lands (thousands of pairs
in one dispatch); the scalar path handles the per-pair UTF-8 snapping.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def prefix_suffix_lengths(old: jnp.ndarray, new: jnp.ndarray,
                          old_len: jnp.ndarray, new_len: jnp.ndarray
                          ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """old, new: (B, L) uint8 padded; old_len/new_len: (B,) int32.
    Returns (prefix_len, suffix_len) per pair, with
    prefix + suffix <= min(old_len, new_len)."""
    B, L = old.shape
    pos = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    minlen = jnp.minimum(old_len, new_len)[:, None]

    eq = (old == new) & (pos < minlen)
    # prefix: first position where eq is False.
    neq_pos = jnp.where(eq, L, pos)
    prefix = jnp.min(neq_pos, axis=1)
    prefix = jnp.minimum(prefix, minlen[:, 0])

    # suffix: align ends, compare old[old_len-1-k] vs new[new_len-1-k].
    k = pos
    oidx = jnp.clip(old_len[:, None] - 1 - k, 0, L - 1)
    nidx = jnp.clip(new_len[:, None] - 1 - k, 0, L - 1)
    eq_s = (jnp.take_along_axis(old, oidx, axis=1)
            == jnp.take_along_axis(new, nidx, axis=1)) & (k < minlen)
    neq_k = jnp.where(eq_s, L, k)
    suffix = jnp.min(neq_k, axis=1)
    suffix = jnp.minimum(suffix, minlen[:, 0] - prefix)
    return prefix, suffix


def batched_highlights(old_lines: list[str], new_lines: list[str]
                       ) -> list[tuple[tuple[int, int], tuple[int, int]]]:
    """Compute highlight byte ranges for B paired lines in one device call.
    Returns [((old_start, old_end), (new_start, new_end))] like
    gitcore.diff.intra_line_highlight, including UTF-8 boundary snapping."""
    from ..gitcore.diff import _snap_utf8

    if not old_lines or not new_lines:
        return []
    assert len(old_lines) == len(new_lines), "pairs must align"
    olds = [s.encode() for s in old_lines]
    news = [s.encode() for s in new_lines]
    # Pad BOTH axes to power-of-two buckets: the kernel is jitted on
    # dynamic shapes, so raw (B, longest-line) would recompile for
    # essentially every distinct diff — seconds of XLA compile time,
    # dwarfing the loop this fast path replaces.
    def _bucket(n: int) -> int:
        b = 64
        while b < n:
            b *= 2
        return b

    B = len(olds)
    L = _bucket(max(1, max(max(len(b) for b in olds),
                           max(len(b) for b in news))))
    Bp = _bucket(B)
    old_arr = np.zeros((Bp, L), np.uint8)
    new_arr = np.zeros((Bp, L), np.uint8)
    for i, (o, n) in enumerate(zip(olds, news)):
        old_arr[i, :len(o)] = np.frombuffer(o, np.uint8)
        new_arr[i, :len(n)] = np.frombuffer(n, np.uint8)
    old_len = np.zeros(Bp, np.int32)
    new_len = np.zeros(Bp, np.int32)
    old_len[:B] = [len(o) for o in olds]
    new_len[:B] = [len(n) for n in news]
    prefix, suffix = prefix_suffix_lengths(
        jnp.asarray(old_arr), jnp.asarray(new_arr),
        jnp.asarray(old_len), jnp.asarray(new_len))
    prefix = np.asarray(prefix)
    suffix = np.asarray(suffix)
    out = []
    for i, (o, n) in enumerate(zip(olds, news)):
        p, s = int(prefix[i]), int(suffix[i])
        oa, ob = _snap_utf8(o, p, False), _snap_utf8(o, len(o) - s, True)
        na, nb = _snap_utf8(n, p, False), _snap_utf8(n, len(n) - s, True)
        if oa >= ob:
            oa = ob = 0
        if na >= nb:
            na = nb = 0
        out.append(((oa, ob), (na, nb)))
    return out
