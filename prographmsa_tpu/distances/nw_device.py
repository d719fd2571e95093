"""All-pairs Needleman-Wunsch on device: fill AND backtrack.

Device replacement for the host-assisted path in ``distances/align.py``:
the affine-gap DP fill runs as one ``lax.scan`` over anti-diagonals (exact
int32 arithmetic), the W/X/Y matrices stay in device memory, and the
*backtrack* also runs on device as a masked batched scan — so the only
host<->device traffic per chunk is the sequence codes up (B*L uint8) and
the per-pair substitution count matrices + gap counts down (B*DIM² uint16
+ B int32).

Exactness: all arithmetic is int32 and the backtrack comparison order
(diagonal match, then X, then Y) replicates
/root/reference/src/DistanceFactoryAlign.h:93-123, so counts/gaps — and
therefore the ML distances and the final MSA — are bit-identical to the
reference and to the host path.
"""

from __future__ import annotations

import functools

import numpy as np

MINFTY = -10000


@functools.lru_cache(maxsize=32)
def _make_kernel(L1: int, L2: int, go: int, ge: int, dim: int,
                 table_n: int):
    import jax
    import jax.numpy as jnp

    D = L1 + L2
    H = L2 + 1          # rows (y)
    Wd = L1 + 1         # cols (x)
    ys_idx = jnp.arange(H)

    def kernel(s1b, s2b, l1, l2, scoring):
        """s1b [B,L1], s2b [B,L2] (any int dtype — uint8 uploads are 4x
        smaller and widened here), l1/l2 [B] i32,
        scoring [table_n, table_n] i32 ->
        (counts [B, dim, dim] u16, gaps [B] i32, w_final [B] i32)."""
        s1b = s1b.astype(jnp.int32)
        s2b = s2b.astype(jnp.int32)
        B = s1b.shape[0]
        bidx = jnp.arange(B)

        # ---- score diagonals, gather-free ----
        # Gather-free:
        # (a) the [B, L2, L1] score lookup is two one-hot matmuls, exact at
        #     "highest" precision (one-hot times small ints stays < 2^24 in
        #     f32; no TF32 rounding of the operands on the GPU);
        # (b) the diagonal reordering is a *shear*: pad each row y by H and
        #     reinterpret row-major memory with stride Wd+H-1, which lands
        #     (y, x) at [y, x+y] — diagonals become columns, zero gathers.
        f32 = jnp.float32
        oh2 = jax.nn.one_hot(s2b, table_n, dtype=f32)            # [B,L2,T]
        oh1 = jax.nn.one_hot(s1b, table_n, dtype=f32)            # [B,L1,T]
        rows = jnp.einsum("byt,tu->byu", oh2, scoring.astype(f32),
                          precision="highest")
        full = jnp.einsum("byu,bxu->byx", rows, oh1,
                          precision="highest")                   # [B,L2,L1]
        fullp = jnp.pad(full.astype(jnp.int32),
                        ((0, 0), (1, 0), (1, 0)))                # [B,H,Wd]
        shear = jnp.pad(fullp, ((0, 0), (0, 0), (0, H)))         # [B,H,Wd+H]
        flat = shear.reshape(B, H * (Wd + H))
        sk = flat[:, :H * (Wd + H - 1)].reshape(B, H, Wd + H - 1)
        # sk[b, y, d] = score(y, x=d-y); diag d=1..D -> scan xs [D, B, H]
        sd = jnp.transpose(sk[:, :, 1:D + 1], (2, 0, 1))
        ds = jnp.arange(1, D + 1)

        # ---- fill: scan over anti-diagonals ----
        def boundary_w(v):
            return go + (v - 1) * ge

        def step(carry, inp):
            d, score = inp
            Wm1, Wm2, Xm1, Ym1 = carry
            xs = d - ys_idx                                      # [H]

            Wm1_up = jnp.roll(Wm1, 1, axis=1)
            Wm2_up = jnp.roll(Wm2, 1, axis=1)
            Ym1_up = jnp.roll(Ym1, 1, axis=1)

            newX = jnp.maximum(Xm1 + ge, Wm1 + go)
            newY = jnp.maximum(Ym1_up + ge, Wm1_up + go)
            newW = jnp.maximum(Wm2_up + score, jnp.maximum(newX, newY))

            is_y0 = ys_idx[None, :] == 0
            is_x0 = xs[None, :] == 0
            bx = boundary_w(xs)[None, :]
            by = boundary_w(ys_idx)[None, :]
            newW = jnp.where(is_y0, bx, jnp.where(is_x0, by, newW))
            newX = jnp.where(is_y0, bx, jnp.where(is_x0, MINFTY, newX))
            newY = jnp.where(is_y0, MINFTY, jnp.where(is_x0, by, newY))
            oob = (xs[None, :] < 0) | (xs[None, :] > L1)
            newW = jnp.where(oob, MINFTY, newW)
            newX = jnp.where(oob, MINFTY, newX)
            newY = jnp.where(oob, MINFTY, newY)
            return (newW, Wm1, newX, newY), (newW, newX)

        init = (jnp.full((B, H), MINFTY, jnp.int32).at[:, 0].set(0),
                jnp.full((B, H), MINFTY, jnp.int32),
                jnp.full((B, H), MINFTY, jnp.int32),
                jnp.full((B, H), MINFTY, jnp.int32))
        _, (Wdg, Xdg) = jax.lax.scan(step, init, (ds, sd))
        # Wdg/Xdg [D, B, H]: diagonal d=y+x lives at index d-1, row y.
        # The backtrack reads these diagonal-major buffers directly — no
        # [B, H, Wd] assembly pass (it was the dominant cost of this kernel).
        # Y is never read: the reference checks match, then X, else Y
        # (DistanceFactoryAlign.h:97-117), so the Y branch is "neither".

        # W and X of the *same* diagonal are read together every step: stack
        # them so one gather fetches both.
        WXdg = jnp.stack([Wdg, Xdg], axis=-1)                    # [D,B,H,2]

        def w_at(y, x):
            """W(y, x) for cells with y+x >= 1 (plus exact (0,0) = 0)."""
            d = y + x
            v = Wdg[jnp.clip(d - 1, 0, D - 1), bidx, y]
            return jnp.where(d == 0, 0, v)

        # ---- backtrack: masked batched scan ----
        # No scatter inside the loop: per-step (idx, valid) records are scan
        # outputs; one big scatter-add folds them into counts afterwards.
        def bt_step(carry, _):
            y, x, go1, go2 = carry
            active = (y > 0) & (x > 0)
            yc = jnp.maximum(y, 1)
            xc = jnp.maximum(x, 1)
            wx = WXdg[yc + xc - 1, bidx, yc]                     # [B, 2]
            w = wx[:, 0]
            s1c = s1b[bidx, xc - 1]
            s2c = s2b[bidx, yc - 1]
            sc = scoring[s2c, s1c]
            diag = w == w_at(yc - 1, xc - 1) + sc
            xmv = (~diag) & (w == wx[:, 1])
            ymv = (~diag) & (~xmv)

            valid = active & diag & (s1c < dim) & (s2c < dim)
            idx = jnp.where(valid, s1c * dim + s2c, dim * dim)

            gap_open = active & ((xmv & ~go1) | (ymv & ~go2))
            go1 = jnp.where(active, xmv, go1)
            go2 = jnp.where(active, ymv, go2)
            y = jnp.where(active & (diag | ymv), y - 1, y)
            x = jnp.where(active & (diag | xmv), x - 1, x)
            return (y, x, go1, go2), (idx, valid, gap_open)

        carry0 = (l2.astype(jnp.int32), l1.astype(jnp.int32),
                  jnp.zeros(B, bool), jnp.zeros(B, bool))
        (y, x, _, _), (idx_all, valid_all, gap_all) = jax.lax.scan(
            bt_step, carry0, None, length=D)

        gaps = gap_all.astype(jnp.int32).sum(axis=0)             # [B]
        counts = jnp.zeros((B, dim * dim + 1), jnp.int32)
        counts = counts.at[
            jnp.broadcast_to(bidx[None, :], (D, B)).reshape(-1),
            idx_all.reshape(-1)].add(valid_all.reshape(-1).astype(jnp.int32))

        w_final = w_at(l2.astype(jnp.int32), l1.astype(jnp.int32))
        # idx = s1*dim + s2 -> reshape gives counts[s1, s2], matching the
        # reference's counts(s1, s2) (DistanceFactoryAlign.h:100).
        # uint16 is exact (counts <= L < 2^16) and halves the fetch.
        counts = counts[:, :dim * dim].reshape(B, dim, dim)
        return counts.astype(jnp.uint16), gaps, w_final

    return jax.jit(kernel)


def nw_counts_device(s1b: np.ndarray, s2b: np.ndarray, l1: np.ndarray,
                     l2: np.ndarray, scoring: np.ndarray, go: int, ge: int,
                     dim: int):
    """Run the fused fill+backtrack kernel; returns host numpy
    (counts [B,dim,dim] int64-castable, gaps [B])."""
    import jax.numpy as jnp

    if s1b.shape[1] >= 2 ** 16 or s2b.shape[1] >= 2 ** 16:
        # counts are fetched as uint16 (exact only while counts <= L < 2^16);
        # same guard as prealigned_device — callers fall back to the host path
        raise ValueError("nw_counts_device: sequence length >= 2^16 would "
                         "overflow the uint16 count transfer")
    kern = _make_kernel(s1b.shape[1], s2b.shape[1], go, ge, dim,
                        scoring.shape[0])
    counts, gaps, _ = kern(jnp.asarray(s1b), jnp.asarray(s2b),
                           jnp.asarray(l1), jnp.asarray(l2),
                           jnp.asarray(scoring))
    return np.asarray(counts), np.asarray(gaps)
