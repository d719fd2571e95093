"""Device graph-pair DP: an anti-diagonal fill that emits per-cell decision
CODES, plus an arithmetic-free XLA code-chase traceback.

One ``align_pairs_device`` call aligns a BATCH of graph pairs end to end on
the GPU:

* **Fill.**  One Pallas program per pair (``backend="triton"``) walks the
  pair's anti-diagonals in a loop that stays on the SM.  Row y of diagonal
  d is cell (y, x = d - y); a predecessor at offset o along g1 is the same
  ring row read o lanes to the left, so every row shift is a masked load
  at lane offset ``y - o``.  The W/Y/X/M rows of the last R diagonals live
  in a ring in device memory (L2-resident at these sizes); a block barrier
  separates writing diagonal d from reading it back.
* **The fill emits decision codes; the traceback never re-derives
  scores.**  The reference's backtrack picks the first candidate whose
  recomputed score matches the stored cell (min |difference|, strict
  improvement, PredIterator order — GraphAlign.h:283-517).  Because the
  stored cell IS the max of those same candidates (computed with identical
  f32 op order), the first argmin equals the first strict-improvement
  attainer **during the fill's own max accumulation** — so the fill
  tracks, per cell, which (offset-slot, move) first attained the running
  max, iterating slots in descending-offset order (= ascending predecessor
  index = PredIterator order; graph/graph.py:18-20).  The packed int32
  code plane is the only O(n1*n2) output.  The fill uses only f32 add,
  subtract and max: there is no product to contract, so it is bitwise
  equal to the host fill.
* **Traceback = code chase.**  An XLA while loop walks the code plane with
  ONE tiny gather per step (plus small table lookups), emitting the
  mapping vectors.  Two exceptions replay the host argmin explicitly with
  values the fill exports on the side:
    - boundary cells (x==0 / y==0): the fill scored them with
      ``start_gap`` but the backtrack compares candidates built with
      ``gap_init`` (backtrack.py:149), so first-attainer != argmin there;
      the fill exports the boundary value stripes Y[:,0] / X[0,:] and the
      chase replays backtrack.py:140-172 bit-exactly on them;
    - the end transition (GraphAlign.h:304-353) needs M/X/Y values at the
      end-node predecessors; they are the ring's rows after the fill, and
      the chase replays the end argmin (including Wend itself) from those.
  A step that selects a repeat edge RECORDS the event — (side, next-node,
  cur-node, emit position) into a fixed-capacity per-pair buffer — and
  walks on; the harvest replays markAlternativePath (GraphAlign.h:166-198)
  on the host for just those events and splices the skipped-unit columns
  into the device mapping at the recorded positions.  A cost TIE between
  a repeat and a normal edge resolves to the normal edge and records
  nothing — matching the host, whose PredIterator visits normal edges
  before repeats.  Pairs with more than EV_CAP events fall back to the
  host (fb_rep); a walk that does not reach the origin falls back as
  fb_chase.

The whole batch is one S launch, one fill launch, one chase launch and one
packed fetch.
"""

from __future__ import annotations

import functools

import numpy as np

NEG = np.float32(-1e37)          # "-inf" of the DP values
COST_INF = np.float32(1e37)      # "+inf" edge cost (the chase tests < it)
FLOOR = np.float32(-3e38)        # max-accumulator init (< any candidate)
BIG = np.float32(3e38)           # min-accumulator init (> any |diff|)

ST_M, ST_X, ST_Y = 0, 1, 2       # states, as in align/backtrack.py
RW, RY, RX, RM = 0, 1, 2, 3      # ring planes

MAX_N = 4096                     # per-side node cap
MAX_OFF = 64                     # offset-slot cap (6-bit code fields)
MAX_RING = 256                   # ring diagonals: reach + 2 must fit

META_SCORE, META_LEN, META_FAIL = 0, 1, 2
FAIL_EVENTS, FAIL_CHASE = 1, 2   # META_FAIL values
EV_CAP = 8                       # repeat events per pair before host bail


def _shb(op: int) -> int:
    """Decision-code slot-field width: 4-bit i/j fields up to 16 offset
    slots, 6-bit up to MAX_OFF."""
    return 4 if op <= 16 else 6


def _pow2(x: int) -> int:
    return 1 << max(0, (int(x) - 1)).bit_length()


# ---------------------------------------------------------------------------
# fallback observability: every pair that leaves the device path is counted
# by reason; the level driver surfaces these in --timings.
FALLBACK_KEYS = ("pairs_total", "pairs_device", "fb_offsets", "fb_size",
                 "fb_reach", "fb_rep", "fb_chase")
_fallback_stats = {k: 0 for k in FALLBACK_KEYS}


def fallback_stats():
    return dict(_fallback_stats)


def reset_fallback_stats():
    for k in FALLBACK_KEYS:
        _fallback_stats[k] = 0


# ---------------------------------------------------------------------------
# host-side pair preparation


def _offset_costs_rep(graph, scores, max_offsets: int):
    """Offset-slot costs with repeat flags, in PredIterator candidate order.

    Returns (offsets [m] i32, C [n, m] f32, rep [n, m] bool) or None if
    the graph needs more than ``max_offsets`` slots.  Slots are SPLIT BY
    KIND: repeat-edge offsets (ascending) occupy the front of the array,
    normal-edge offsets (ascending) the back.  The fill and the chase both
    walk slots from the BACK of the array forward, so candidates are
    visited normal-desc-offset (= ascending predecessor index) THEN
    repeat-desc-offset — exactly the host PredIterator's
    normals-before-repeats order (Graph.h:180-248), so cross-kind cost
    TIES resolve to the normal edge like the host.

    C[i, k] = min cost over same-kind edges i -> i-offsets[k]
    (normal edges as stored; repeat edges repeat_init +
    repeat_ext*(units-1), NaN (inf*0) => unreachable); rep[i, k] is True
    iff slot k is a repeat slot with a real edge into node i (the chase
    records a markAlternativePath event when it steps through one)."""
    n = graph.size
    off_n, off_r = set(), set()
    for i in range(n):
        for p, _ in graph.preds[i]:
            off_n.add(i - p)
        for p, _ in graph.reps[i]:
            off_r.add(i - p)
    off_n = sorted(off_n)
    off_r = sorted(off_r)
    slots = off_r + off_n
    if len(slots) > max_offsets:
        return None
    m = max(1, len(slots))
    C = np.full((n, m), np.inf, dtype=np.float32)
    rep = np.zeros((n, m), dtype=bool)
    nmap = {o: len(off_r) + k for k, o in enumerate(off_n)}
    rmap = {o: k for k, o in enumerate(off_r)}
    ri = np.float32(scores.repeat_init)
    re = np.float32(scores.repeat_ext)
    for i in range(n):
        for p, c in graph.preds[i]:
            k = nmap[i - p]
            c32 = np.float32(c)
            if c32 < C[i, k]:
                C[i, k] = c32
        for p, u in graph.reps[i]:
            k = rmap[i - p]
            with np.errstate(invalid="ignore"):
                rc = np.float32(ri + re * np.float32(u - 1))
            if np.isnan(rc):
                continue                     # NaN cost: never chosen
            if rc < C[i, k]:
                C[i, k] = rc
            rep[i, k] = True
    return (np.array(slots, dtype=np.int32) if slots
            else np.array([1], dtype=np.int32)), C, rep


class _PairInfo:
    __slots__ = ("idx", "g1", "g2", "model", "scores", "n1", "n2", "o1",
                 "C1", "rep1", "o2", "C2", "rep2", "reach")

    def __init__(self, idx, g1, g2, model, scores):
        self.idx = idx
        self.g1, self.g2 = g1, g2
        self.model, self.scores = model, scores
        self.n1, self.n2 = g1.size, g2.size


def _prep_pair(idx, g1, g2, model, scores):
    """Offset/cost tables for one pair, or a fallback-reason string."""
    if g1.size > MAX_N or g2.size > MAX_N:
        return "fb_size"
    oc1 = _offset_costs_rep(g1, scores, MAX_OFF)
    oc2 = _offset_costs_rep(g2, scores, MAX_OFF)
    if oc1 is None or oc2 is None:
        return "fb_offsets"
    info = _PairInfo(idx, g1, g2, model, scores)
    info.o1, info.C1, info.rep1 = oc1
    info.o2, info.C2, info.rep2 = oc2
    # "no edge" is the finite COST_INF: the chase tests `cost < COST_INF`
    info.C1 = np.where(np.isfinite(info.C1), info.C1,
                       COST_INF).astype(np.float32)
    info.C2 = np.where(np.isfinite(info.C2), info.C2,
                       COST_INF).astype(np.float32)
    info.reach = int(info.o1.max()) + int(info.o2.max())
    if info.reach + 2 > MAX_RING:
        return "fb_reach"
    return info


# ---------------------------------------------------------------------------
# one anti-diagonal of the fill

_UNROLL = 4                      # slot loops up to this count are unrolled


def _loop(n, body, carry):
    import jax
    if isinstance(n, int) and n <= _UNROLL:
        for ii in range(n):
            carry = body(ii, carry)
        return carry
    return jax.lax.fori_loop(0, n, body, carry)


def _fill_diag(d, ys, n1, n2, ge, gi, sg, s_row, ring, c1, c2, o1, o2,
               k1, k2, SHB):
    """Cells of anti-diagonal d.  ``ring(k, dd, shift)`` is ring plane k
    on diagonal dd with lanes shifted right by ``shift`` (NEG where
    y < shift or dd < 0); ``c1(i)``/``c2(j)`` are the rows of edge costs
    into node y / node x = d - y at offset slot i / j; ``o1``/``o2`` the
    slot offsets; ``k1``/``k2`` the slot counts.  Returns the clamped
    (M, X, Y, W) rows and the packed decision code row."""
    import jax.numpy as jnp

    i32 = jnp.int32
    floor = jnp.full(s_row.shape, FLOOR, jnp.float32)
    zero = jnp.zeros(s_row.shape, i32)

    def acc(a, c, cand, code):
        """Strict-improvement max + first-attainer code tracking."""
        upd = cand > a
        return jnp.where(upd, cand, a), jnp.where(upd, code, c)

    # g1-offset slots in DESCENDING slot order = PredIterator candidate
    # order (normal desc-offset then repeat desc-offset)
    def y_body(ii, carry):
        aY, cY, aYB = carry
        i = k1 - 1 - ii
        oi, ci = o1(i), c1(i)
        w = ring(RW, d - oi, oi)
        t_ge = ring(RY, d - oi, oi) + ge
        # Y candidates in per-edge order: Y then W move
        aY, cY = acc(aY, cY, t_ge - ci, (i << 1) | 0)
        aY, cY = acc(aY, cY, (w + gi) - ci, (i << 1) | 1)
        aYB = jnp.maximum(aYB, jnp.maximum(t_ge, w + sg) - ci)
        return aY, cY, aYB

    aY, cY, aYB = _loop(k1, y_body, (floor, zero, floor))

    def m_body(ii, carry):
        i = k1 - 1 - ii
        oi, ci = o1(i), c1(i)

        def inner(jj, carry):
            aM, cM = carry
            j = k2 - 1 - jj
            w2 = ring(RW, d - oi - o2(j), oi)
            return acc(aM, cM, ((w2 + s_row) - ci) - c2(j), (i << SHB) | j)

        return _loop(k2, inner, carry)

    aM, cM = _loop(k1, m_body, (floor, zero))

    def x_body(jj, carry):
        aX, cX, aXB = carry
        j = k2 - 1 - jj
        oj, cj = o2(j), c2(j)
        w = ring(RW, d - oj, 0)
        t_ge = ring(RX, d - oj, 0) + ge
        aX, cX = acc(aX, cX, t_ge - cj, (j << 1) | 0)
        aX, cX = acc(aX, cX, (w + gi) - cj, (j << 1) | 1)
        aXB = jnp.maximum(aXB, jnp.maximum(t_ge, w + sg) - cj)
        return aX, cX, aXB

    aX, cX, aXB = _loop(k2, x_body, (floor, zero, floor))

    xs = d - ys
    interior = (ys >= 1) & (ys <= n1 - 2) & (xs >= 1) & (xs <= n2 - 2)
    b_x0 = (xs == 0) & (ys >= 1) & (ys <= n1 - 2)
    b_y0 = (ys == 0) & (xs >= 1) & (xs <= n2 - 2)
    M = jnp.where(interior, aM, NEG)
    X = jnp.where(interior, aX, jnp.where(b_y0, aXB, NEG))
    Y = jnp.where(interior, aY, jnp.where(b_x0, aYB, NEG))
    W = jnp.where(interior, jnp.maximum(M, jnp.maximum(X, Y)),
                  jnp.where(b_x0, aYB, jnp.where(b_y0, aXB, NEG)))
    M = jnp.maximum(M, NEG)       # clamp junk drift toward -3e38
    X = jnp.maximum(X, NEG)
    Y = jnp.maximum(Y, NEG)
    W = jnp.maximum(W, NEG)
    # W-state resolution order M, Y, X (backtrack.py:130-137)
    wst = jnp.where(W == M, ST_M, jnp.where(W == Y, ST_Y, ST_X)).astype(i32)
    code = (cM | (cY << (2 * SHB)) | (cX << (3 * SHB + 1))
            | (wst << (4 * SHB + 2)))
    return M, X, Y, W, code


# ---------------------------------------------------------------------------
# fill: one Pallas (Triton) program per pair


def _num_warps(n1p: int) -> int:
    return max(4, min(16, n1p // 128))


@functools.lru_cache(maxsize=64)
def _make_fill(B: int, n1p: int, DB: int, op: int, R: int,
               interpret: bool):
    """Fill for B pairs at lane width n1p (a power of two), DB diagonals,
    ``op`` offset slots and an R-diagonal ring.  Returns a jitted
    (ints, pars, O1, O2, C1, C2x, Sdiag) -> (codes, rings, stripeY,
    stripeX)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    SHB = _shb(op)
    f32, i32 = jnp.float32, jnp.int32
    RP = R + n1p                   # ring row: R pad lanes, then n1p lanes
    SX = DB + n1p                  # boundary-X stripe width

    def kernel(ints_ref,           # [B, 8] i32: n1, n2, dlast, m1, m2
               pars_ref,           # [B, 8] f32: ge, gi, sg, si, ...
               o1_ref, o2_ref,     # [B, op] i32 slot offsets
               c1_ref,             # [B, op, n1p] f32 costs into node y
               c2_ref,             # [B, op, SX] f32 C2 mirrored: lane
                                   #   DB-1-d+y holds the cost into d-y
               s_ref,              # [B, DB, n1p] f32 S by diagonal
               codes_ref,          # [B, DB, n1p] i32
               ring_ref,           # [B, 4, R, RP] f32 (W, Y, X, M)
               sty_ref,            # [B, n1p] f32: Y[y, 0]
               stx_ref):           # [B, SX] f32: X[0, x]
        b = pl.program_id(0)
        n1, n2, dlast = ints_ref[b, 0], ints_ref[b, 1], ints_ref[b, 2]
        m1, m2 = ints_ref[b, 3], ints_ref[b, 4]
        ge, gi = pars_ref[b, 0], pars_ref[b, 1]
        sg, si = pars_ref[b, 2], pars_ref[b, 3]
        ys = jax.lax.broadcasted_iota(i32, (n1p,), 0)
        neg = jnp.full((n1p,), NEG, f32)

        def ring(k, dd, shift):
            return plgpu.load(
                ring_ref.at[b, k, dd & (R - 1), pl.ds(R - shift, n1p)],
                mask=(ys >= shift) & (dd >= 0), other=NEG)

        def put(k, d, row):
            plgpu.store(ring_ref.at[b, k, d & (R - 1), pl.ds(R, n1p)], row)

        # diagonal 0: cell (0, 0) holds W = start_init
        put(RW, 0, jnp.where(ys == 0, si, NEG))
        for k in (RY, RX, RM):
            put(k, 0, neg)
        codes_ref[b, 0, :] = jnp.zeros((n1p,), i32)
        sty_ref[b, :] = neg
        plgpu.store(stx_ref.at[b, pl.ds(0, n1p)], neg, mask=ys == 0)
        if not interpret:
            plgpu.debug_barrier()

        # small slot counts unroll over the padded width (padded slots
        # cost COST_INF and never win a real cell); larger ones loop over
        # the pair's own count
        k1 = op if op <= _UNROLL else m1
        k2 = op if op <= _UNROLL else m2

        def body(d, carry):
            M, X, Y, W, code = _fill_diag(
                d, ys, n1, n2, ge, gi, sg, s_ref[b, d, :], ring,
                lambda i: c1_ref[b, i, :],
                lambda j: plgpu.load(c2_ref.at[b, j,
                                               pl.ds(DB - 1 - d, n1p)]),
                lambda i: o1_ref[b, i], lambda j: o2_ref[b, j],
                k1, k2, SHB)
            codes_ref[b, d, :] = code
            put(RW, d, W)
            put(RY, d, Y)
            put(RX, d, X)
            put(RM, d, M)
            # boundary stripes: Y[y, 0] sits at lane y of diagonal y,
            # X[0, x] at lane 0 of diagonal x
            plgpu.store(sty_ref.at[b, pl.ds(0, n1p)], Y, mask=ys == d)
            plgpu.store(stx_ref.at[b, pl.ds(d, n1p)], X, mask=ys == 0)
            if not interpret:
                plgpu.debug_barrier()   # diagonal d is read back at d + 1
            return carry

        jax.lax.fori_loop(1, dlast + 1, body, 0)

    call = pl.pallas_call(
        kernel,
        grid=(B,),
        out_shape=[
            jax.ShapeDtypeStruct((B, DB, n1p), i32),
            jax.ShapeDtypeStruct((B, 4, R, RP), f32),
            jax.ShapeDtypeStruct((B, n1p), f32),
            jax.ShapeDtypeStruct((B, SX), f32),
        ],
        backend="triton",
        interpret=interpret,
        compiler_params=plgpu.CompilerParams(num_warps=_num_warps(n1p),
                                             num_stages=1),
        name="graph_dp_fill",
    )
    return jax.jit(call)


# ---------------------------------------------------------------------------
# S by diagonal: Sdiag[b, d, y] = S[y, d - y] (NEG outside the pair)


def _shear(S, DB: int):
    """[b, n1p, n2s] -> [b, DB, n1p] by diagonal, gather-free: pad each
    row to DB + 1 and reread the buffer with row stride DB, which moves
    S[y, x] to column x + y; DB >= n1p + n2s keeps the wrap in the pad."""
    import jax.numpy as jnp

    b, n1p, n2s = S.shape
    A = jnp.pad(S, ((0, 0), (0, 0), (0, DB + 1 - n2s)),
                constant_values=NEG)
    T = A.reshape(b, -1)[:, :n1p * DB].reshape(b, n1p, DB)
    Sd = jnp.swapaxes(T, 1, 2)
    return jnp.where(jnp.isnan(Sd) | (Sd < NEG), NEG, Sd)


@functools.lru_cache(maxsize=16)
def _make_shear(DB: int):
    import jax
    return jax.jit(functools.partial(_shear, DB=DB))


def _host_s(flat, n1p, n2s):
    """Exact S of every pair on the host (the native tier), NEG-padded to
    [B, n1p, n2s]."""
    from .scores import precompute_scores

    S = np.full((len(flat), n1p, n2s), NEG, np.float32)
    for b, info in enumerate(flat):
        if info is not None:
            S[b, :info.n1, :info.n2] = precompute_scores(
                info.g1, info.g2, info.model, info.scores)
    return S


# ---------------------------------------------------------------------------
# XLA code chase (traceback)


@functools.lru_cache(maxsize=4)
def _make_chase():
    import jax
    import jax.numpy as jnp

    i32 = jnp.int32
    NEGc = jnp.float32(NEG)
    BIGc = jnp.float32(BIG)

    def take(flat, idx):
        return jnp.take(flat, idx, mode="clip")

    def chase(codes, rings, stripeY, stripeX,
              O1b, O2b, C1f, C2f, R1f, R2f, parb, n1b, n2b):
        """codes [B, DB, n1p] i32; rings [B, 4, R, R + n1p] f32; stripes
        [B, n1p] / [B, SX] f32; O1b/O2b [B, op] i32; C1f/C2f [B, n1p|n2s,
        op] f32; R1f/R2f same shape i32; parb [B, 8] f32 (ge, gi, sg, si,
        em, eg, es); n1b/n2b [B] i32.
        Returns (m1 [B, Lm] i32, m2, meta [B, 16] f32, ev)."""
        B, DB, n1p = codes.shape
        R, RP = rings.shape[2], rings.shape[3]
        SX = stripeX.shape[1]
        op = O1b.shape[1]
        SHB = _shb(op)                   # code field widths follow op
        SMSK = (1 << SHB) - 1
        npad1 = C1f.shape[1]
        npad2 = C2f.shape[1]
        Lm = DB + 8
        bidx = jnp.arange(B)
        ge, gi = parb[:, 0], parb[:, 1]
        si = parb[:, 3]
        em, eg, es = parb[:, 4], parb[:, 5], parb[:, 6]

        codesf = codes.reshape(-1)
        ringsf = rings.reshape(-1)
        strYf = stripeY.reshape(-1)
        strXf = stripeX.reshape(-1)
        R1ff = R1f.reshape(-1)
        R2ff = R2f.reshape(-1)

        def code_at(y, x):
            return take(codesf, (bidx * DB + (y + x)) * n1p + y)

        def ring_at(k, yp, xp):
            """[..., extra] value of state k at (yp, xp) from the ring
            (the last R diagonals hold every end predecessor); the
            origin reads NEG."""
            ex = yp.shape[1:]
            be = bidx.reshape((B,) + (1,) * len(ex))
            slot = (yp + xp) & (R - 1)
            v = take(ringsf, ((be * 4 + k) * R + slot) * RP + R + yp)
            return jnp.where((yp == 0) & (xp == 0), NEGc, v)

        def stripe_at(flatP, pos, width):
            ex = pos.shape[1:]
            be = bidx.reshape((B,) + (1,) * len(ex))
            return take(flatP, be * width + pos)

        # ---- end transition (GraphAlign.h:304-353 / backtrack.py:75-108)
        # candidate order: slots in descending offset (= PredIterator
        # ascending-p) outer over g1, inner over g2, then [M, Y, X, skip]
        o1d = O1b[:, ::-1]                       # descending offsets
        o2d = O2b[:, ::-1]
        yend = (n1b - 1)[:, None]
        xend = (n2b - 1)[:, None]
        ypi = yend - o1d                         # [B, op]
        xpi = xend - o2d
        cyE = C1f[bidx, n1b - 1][:, ::-1]        # [B, op] desc-slot order
        cxE = C2f[bidx, n2b - 1][:, ::-1]
        yp2 = jnp.broadcast_to(ypi[:, :, None], (B, op, op))
        xp2 = jnp.broadcast_to(xpi[:, None, :], (B, op, op))
        okp = (yp2 >= 0) & (xp2 >= 0)
        ypc = jnp.maximum(yp2, 0)
        xpc = jnp.maximum(xp2, 0)
        Mv = ring_at(RM, ypc, xpc)
        Yv = ring_at(RY, ypc, xpc)
        Xv = ring_at(RX, ypc, xpc)
        cy2 = cyE[:, :, None]
        cx2 = cxE[:, None, :]
        emb = em[:, None, None]
        egb = eg[:, None, None]
        candM = ((Mv + emb) - cy2) - cx2
        candY = ((Yv + egb) - cy2) - cx2
        candX = ((Xv + egb) - cy2) - cx2
        both0 = (yp2 == 0) & (xp2 == 0)
        candS = jnp.where(both0, (es[:, None, None] - cy2) - cx2, -BIGc)
        valid = okp & (cy2 < COST_INF) & (cx2 < COST_INF)
        c4 = jnp.stack([candM, candY, candX, candS], axis=3)
        v4 = jnp.stack([valid, valid, valid, valid & both0], axis=3)
        c4m = jnp.where(v4, c4, -BIGc)
        Wend = c4m.reshape(B, -1).max(axis=1)
        diff = jnp.where(v4, jnp.abs(Wend[:, None, None, None] - c4), BIGc)
        k0 = jnp.argmin(diff.reshape(B, -1), axis=1).astype(i32)
        t0 = k0 % 4
        ab0 = k0 // 4
        a0 = ab0 // op                           # position in DESC order
        b0 = ab0 % op
        i0 = (op - 1) - a0                       # real slot index
        j0 = (op - 1) - b0
        pick2 = lambda A: A.reshape(B, -1)[bidx, ab0]
        y0 = jnp.maximum(pick2(yp2), 0)
        x0 = jnp.maximum(pick2(xp2), 0)
        st0 = jnp.where(t0 == 0, ST_M,
                        jnp.where(t0 == 1, ST_Y, ST_X)).astype(i32)
        # skip candidate wins -> origin (st unused)
        y0 = jnp.where(t0 == 3, 0, y0)
        x0 = jnp.where(t0 == 3, 0, x0)
        rep0y = take(R1ff, (bidx * npad1 + (n1b - 1)) * op + i0) > 0
        rep0x = take(R2ff, (bidx * npad2 + (n2b - 1)) * op + j0) > 0

        # ---- repeat-event buffers (markAlternativePath replays on host)
        eidx = jnp.arange(EV_CAP)

        def add_event(evs, evn, fail, side, nxt, cur, pos, cond):
            ov = cond & (evn >= EV_CAP)
            cond = cond & ~ov
            side_a, next_a, cur_a, pos_a = evs
            sel = cond[:, None] & (eidx[None, :] == evn[:, None])
            side_a = jnp.where(sel, side, side_a)
            next_a = jnp.where(sel, nxt[:, None], next_a)
            cur_a = jnp.where(sel, cur[:, None], cur_a)
            pos_a = jnp.where(sel, pos[:, None], pos_a)
            return ((side_a, next_a, cur_a, pos_a),
                    jnp.where(cond, evn + 1, evn), fail | ov)

        evs = tuple(jnp.zeros((B, EV_CAP), i32) for _ in range(4))
        evn = jnp.zeros(B, i32)
        fail0 = jnp.zeros(B, bool)

        lmax_ii = jnp.arange(Lm)
        map1 = jnp.full((B, Lm), -2, i32)
        map2 = jnp.full((B, Lm), -2, i32)

        def push(maps, pos, y, x, valid_):
            m1, m2 = maps
            sel = valid_[:, None] & (lmax_ii[None, :] == pos[:, None])
            m1 = jnp.where(sel, y[:, None], m1)
            m2 = jnp.where(sel, x[:, None], m2)
            return (m1, m2), jnp.where(valid_, pos + 1, pos)

        def push_state(maps, pos, y, x, st, valid_):
            e1_ = jnp.where(st == ST_X, -1, y)
            e2_ = jnp.where(st == ST_Y, -1, x)
            return push(maps, pos, e1_, e2_, valid_)

        maps, pos0 = push((map1, map2), jnp.zeros(B, i32),
                          n1b - 1, n2b - 1, jnp.ones(B, bool))
        # end-transition repeat events: host marks the y-side path first,
        # then the x-side, both BEFORE pushing (y0, x0) — record both at
        # pos0 (the cumulative-shift splice reproduces the order)
        evs, evn, fail0 = add_event(evs, evn, fail0, 1, y0, n1b - 1,
                                    pos0, rep0y)
        evs, evn, fail0 = add_event(evs, evn, fail0, 2, x0, n2b - 1,
                                    pos0, rep0x)
        live0 = (x0 != 0) | (y0 != 0)
        maps, pos1 = push_state(maps, pos0, y0, x0, st0, live0 & ~fail0)
        code0 = code_at(y0, x0)

        def bt_cond(s):
            y, x, st, code, pos, fail, it, maps_, evs_, evn_ = s
            return jnp.any(((y != 0) | (x != 0)) & (~fail)) & (it < Lm)

        def bt_body(s):
            y, x, st, code, pos, fail, it, maps_, evs_, evn_ = s
            act = ((y != 0) | (x != 0)) & (~fail)

            # interior decode straight from the fill's code word
            iM = (code >> SHB) & SMSK
            jM = code & SMSK
            rwY = (code >> (2 * SHB)) & 1
            iY = (code >> (2 * SHB + 1)) & SMSK
            rwX = (code >> (3 * SHB + 1)) & 1
            jX = (code >> (3 * SHB + 2)) & SMSK

            isY = st == ST_Y
            isX = st == ST_X
            on_bx = x == 0
            on_by = y == 0

            # Boundary replays (backtrack.py:140-172): the stored boundary
            # cells used start_gap but candidates use gap_init, so the
            # argmin is replayed explicitly from the exported stripes.
            # A walk only touches the boundaries near its tail, so both
            # blocks run under lax.cond gated on "any lane on a boundary
            # this step" (the untaken branch returns dummies that the
            # interior selects never read).
            need_b = jnp.any((act & isY & on_bx) | (act & isX & on_by))

            def boundary_replay(_):
                ypb = y[:, None] - O1b[:, ::-1]              # desc order
                okb = ypb >= 0
                sy = stripe_at(strYf, jnp.maximum(ypb, 0), n1p)
                yv = jnp.where(ypb == 0, NEGc, sy)
                wv = jnp.where(ypb == 0, si[:, None], sy)
                cyb = C1f[bidx, jnp.clip(y, 0, npad1 - 1)][:, ::-1]
                csY = stripe_at(strYf, y[:, None], n1p)[:, 0]
                d1 = jnp.abs(csY[:, None] - ((yv + ge[:, None]) - cyb))
                d2 = jnp.abs(csY[:, None] - ((wv + gi[:, None]) - cyb))
                candB = jnp.where(
                    okb[:, :, None] & (cyb < COST_INF)[:, :, None],
                    jnp.stack([d1, d2], 2), BIGc).reshape(B, -1)
                kB = jnp.argmin(candB, axis=1).astype(i32)

                xpb = x[:, None] - O2b[:, ::-1]
                okb2 = xpb >= 0
                sx = stripe_at(strXf, jnp.maximum(xpb, 0), SX)
                xv = jnp.where(xpb == 0, NEGc, sx)
                wv2 = jnp.where(xpb == 0, si[:, None], sx)
                cxb = C2f[bidx, jnp.clip(x, 0, npad2 - 1)][:, ::-1]
                csX = stripe_at(strXf, x[:, None], SX)[:, 0]
                e1 = jnp.abs(csX[:, None] - ((xv + ge[:, None]) - cxb))
                e2 = jnp.abs(csX[:, None] - ((wv2 + gi[:, None]) - cxb))
                candB2 = jnp.where(
                    okb2[:, :, None] & (cxb < COST_INF)[:, :, None],
                    jnp.stack([e1, e2], 2), BIGc).reshape(B, -1)
                kB2 = jnp.argmin(candB2, axis=1).astype(i32)
                return kB, kB2

            kB, kB2 = jax.lax.cond(
                need_b, boundary_replay,
                lambda _: (jnp.zeros(B, i32), jnp.zeros(B, i32)), 0)
            iB = (op - 1) - (kB // 2)
            rwB = kB % 2
            jB = (op - 1) - (kB2 // 2)
            rwB2 = kB2 % 2
            i_sel = jnp.where(isY, jnp.where(on_bx, iB, iY), iM)
            j_sel = jnp.where(isX, jnp.where(on_by, jB, jX), jM)
            rw = jnp.where(isY, jnp.where(on_bx, rwB, rwY),
                           jnp.where(isX, jnp.where(on_by, rwB2, rwX), 1))
            o1s = take(O1b.reshape(-1), bidx * op + i_sel)
            o2s = take(O2b.reshape(-1), bidx * op + j_sel)
            ny = jnp.where(isX, y, jnp.maximum(y - o1s, 0))
            nx = jnp.where(isY, x, jnp.maximum(x - o2s, 0))
            rep1 = jnp.where(isX, 0,
                             take(R1ff, (bidx * npad1
                                         + jnp.clip(y, 0, npad1 - 1)) * op
                                  + i_sel))
            rep2 = jnp.where(isY, 0,
                             take(R2ff, (bidx * npad2
                                         + jnp.clip(x, 0, npad2 - 1)) * op
                                  + j_sel))
            # record repeat events (host order: y-side mark, x-side mark,
            # then the push of (ny, nx)) at the pre-push position
            evs_, evn_, n_fail = add_event(evs_, evn_, fail, 1, ny, y,
                                           pos, act & (rep1 > 0))
            evs_, evn_, n_fail = add_event(evs_, evn_, n_fail, 2, nx, x,
                                           pos, act & (rep2 > 0))

            code2 = code_at(ny, nx)
            wst2 = (code2 >> (4 * SHB + 2)) & 3
            n_st = jnp.where(rw == 1, wst2,
                             jnp.where(isY, ST_Y, ST_X)).astype(i32)

            live = (ny != 0) | (nx != 0)
            maps_, pos = push_state(maps_, pos, ny, nx, n_st,
                                    act & live & ~n_fail)
            y = jnp.where(act, ny, y)
            x = jnp.where(act, nx, x)
            st = jnp.where(act, n_st, st)
            code = jnp.where(act, code2, code)
            return (y, x, st, code, pos, n_fail, it + 1, maps_, evs_,
                    evn_)

        (y_f, x_f, st_f, code_f, pos_f, ovf, it_f, maps, evs,
         evn) = jax.lax.while_loop(bt_cond, bt_body,
                                   (y0, x0, st0, code0, pos1, fail0,
                                    i32(0), maps, evs, evn))
        # lanes still away from the origin at the iteration cap: chase
        # failure (should not happen; bails to host rather than looping)
        lost = ~ovf & ((y_f != 0) | (x_f != 0))
        fail_f = ovf | lost
        maps, posF = push(maps, pos_f, jnp.zeros(B, i32), jnp.zeros(B, i32),
                          ~fail_f)
        m1, m2 = maps
        meta = jnp.zeros((B, 16), jnp.float32)
        meta = meta.at[:, META_SCORE].set(Wend)
        meta = meta.at[:, META_LEN].set(posF.astype(jnp.float32))
        meta = meta.at[:, META_FAIL].set(
            jnp.where(ovf, FAIL_EVENTS, jnp.where(lost, FAIL_CHASE, 0))
            .astype(jnp.float32))
        ev = jnp.concatenate([evn[:, None]] + list(evs), axis=1)
        # one int32 array: the batch costs ONE fetch
        mi = jax.lax.bitcast_convert_type(meta, jnp.int32)
        return jnp.concatenate([m1, m2, mi, ev], axis=1)

    return jax.jit(chase)


# ---------------------------------------------------------------------------
# batch orchestration


def _dims(infos, ndev: int = 1):
    """Static launch shape of a batch: (B, n1p, n2s, DB, op, R).  Every
    dimension is a power of two (or a sum of two) so that kernel shapes
    repeat across tree levels; the batch pads to a multiple of ``ndev``
    with pairs that run no diagonal."""
    B = _pow2(len(infos))
    B = -(-B // ndev) * ndev
    n1p = max(16, _pow2(max(i.n1 for i in infos)))
    n2s = max(16, _pow2(max(i.n2 for i in infos)))
    op = _pow2(max(max(len(i.o1), len(i.o2)) for i in infos))
    R = max(4, _pow2(max(i.reach for i in infos) + 2))
    return B, n1p, n2s, n1p + n2s, op, R


def _launch_bytes(infos, ndev: int = 1) -> int:
    """Device bytes one launch holds at its peak, per device."""
    B, n1p, n2s, DB, op, R = _dims(infos, ndev)
    per_pair = (2 * DB * n1p * 4                 # codes + Sdiag
                + 3 * n1p * n2s * 4              # S, its pad and transpose
                + 4 * R * (R + n1p) * 4          # rings
                + op * (DB + n1p) * 4            # mirrored C2
                + 4 * (n1p + n2s) * op * 4)      # chase tables
    return B // ndev * per_pair


@functools.lru_cache(maxsize=1)
def _device_budget() -> float:
    """Half of one device's memory (``bytes_limit``); 4 GB where the
    backend reports none (CPU)."""
    import jax

    stats = jax.local_devices()[0].memory_stats()
    if stats and stats.get("bytes_limit"):
        return 0.5 * stats["bytes_limit"]
    return 4e9


def _multiprocess(mesh) -> bool:
    return len({d.process_index for d in mesh.devices.flat}) > 1


@functools.lru_cache(maxsize=16)
def _make_mesh_run(mesh, fill, n_fill_args: int, n_chase_args: int):
    """Fill + chase under ONE shard_map over the mesh's pairs axis."""
    import jax
    from jax.sharding import PartitionSpec as PS

    from ..parallel.sharded import _shard_map

    chase = _make_chase()
    multiproc = _multiprocess(mesh)

    def run(fargs, cargs):
        p = chase(*fill(*fargs), *cargs)
        if multiproc:
            # every process needs the whole result (the harvest runs
            # host-side in each controller): one tiled all_gather
            p = jax.lax.all_gather(p, "pairs", axis=0, tiled=True)
        return p

    return jax.jit(_shard_map(run, mesh,
                              ((PS("pairs"),) * n_fill_args,
                               (PS("pairs"),) * n_chase_args),
                              PS() if multiproc else PS("pairs")))


def _launch(infos, interpret, timers=None, mesh=None):
    """S, fill and chase for one batch.  Returns (flat, packed device
    array, Lm).  With ``mesh``, fill and chase run under ONE shard_map
    over the pairs axis — a guide-tree level's pairs spread across every
    device of the mesh."""
    import jax
    import jax.numpy as jnp

    ndev = mesh.size if mesh is not None else 1
    B, n1p, n2s, DB, op, R = _dims(infos, ndev)
    SX = DB + n1p
    flat = list(infos) + [None] * (B - len(infos))

    ints = np.zeros((B, 8), np.int32)
    ints[:, 0:2] = 2                     # padding pairs: 2-node, no diag
    pars = np.zeros((B, 8), np.float32)
    O1 = np.ones((B, op), np.int32)
    O2 = np.ones((B, op), np.int32)
    C1 = np.full((B, op, n1p), COST_INF, np.float32)
    C2x = np.full((B, op, SX), COST_INF, np.float32)
    C1f = np.full((B, n1p, op), COST_INF, np.float32)
    C2f = np.full((B, n2s, op), COST_INF, np.float32)
    C1f[:, 1, 0] = C2f[:, 1, 0] = 0.0    # padding pairs end at the origin
    R1f = np.zeros((B, n1p, op), np.int32)
    R2f = np.zeros((B, n2s, op), np.int32)
    for b, info in enumerate(infos):
        m1_, m2_ = len(info.o1), len(info.o2)
        n1, n2 = info.n1, info.n2
        # the fill runs through the end cell's diagonal minus one: the
        # ring then holds every end predecessor for the chase
        ints[b, :5] = (n1, n2, n1 + n2 - 3, m1_, m2_)
        sc = info.scores
        pars[b, :7] = (sc.gap_extend, sc.gap_init, sc.start_gap,
                       sc.start_init, sc.end_match, sc.end_gap, sc.end_skip)
        O1[b, :m1_] = info.o1
        O2[b, :m2_] = info.o2
        C1[b, :m1_, :n1] = info.C1.T
        C2x[b, :m2_, DB - n2:DB] = info.C2[::-1].T
        C1f[b, :n1] = COST_INF
        C2f[b, :n2] = COST_INF
        C1f[b, :n1, :m1_] = info.C1
        C2f[b, :n2, :m2_] = info.C2
        R1f[b, :n1, :m1_] = info.rep1
        R2f[b, :n2, :m2_] = info.rep2

    Sdiag = _make_shear(DB)(jnp.asarray(_host_s(flat, n1p, n2s)))
    if timers is not None:
        Sdiag.block_until_ready()
        timers("scores")

    fill = _make_fill(B // ndev, n1p, DB, op, R, interpret)
    chase = _make_chase()
    fill_args = (ints, pars, O1, O2, C1, C2x)
    chase_args = (O1, O2, C1f, C2f, R1f, R2f, pars, ints[:, 0], ints[:, 1])

    if mesh is None:
        outs = fill(*fill_args, Sdiag)
        if timers is not None:
            outs[0].block_until_ready()
            timers("fill")
        packed = chase(*outs, *chase_args)
        if timers is not None:
            packed.block_until_ready()
            timers("chase")
    else:
        from jax.sharding import NamedSharding, PartitionSpec as PS

        fargs = fill_args + (Sdiag,)
        if _multiprocess(mesh):
            # multi-controller: inputs must be global arrays; the host
            # data is identical in every process, so replicate it
            repl = NamedSharding(mesh, PS())

            def g(a):
                a = np.asarray(a)
                return jax.make_array_from_callback(
                    a.shape, repl, lambda idx: a[idx])

            fargs = tuple(g(a) for a in fargs)
            chase_args = tuple(g(a) for a in chase_args)
        packed = _make_mesh_run(mesh, fill, len(fargs),
                                len(chase_args))(fargs, chase_args)
        if timers is not None:
            packed.block_until_ready()
            timers("fill+chase")
    return flat, packed, DB + 8


def align_pairs_device(items, interpret=False, mesh=None, profile=None):
    """Fused device alignment of a BATCH of pairs: one S + fill + chase
    launch per memory-bounded chunk and ONE packed result fetch each.
    ``items``: list of (g1, g2, model, scores).  Returns a list of
    (mapping1, mapping2, score, n_tr_indels) — None per pair that falls
    back to the host (counted by reason in ``fallback_stats``).
    ``interpret``: run the fill in the Pallas interpreter (tests on a
    host without a GPU).  ``mesh``: a 1-D ``pairs`` mesh — the batch
    shards over its devices.  ``profile``: a dict to fill with per-phase
    wall times (adds device syncs between stages — measurement only)."""
    import time as _time

    t_mark = [_time.perf_counter()]

    def _mark(label):
        now = _time.perf_counter()
        profile[label] = profile.get(label, 0.0) + (now - t_mark[0])
        t_mark[0] = now

    timers = _mark if profile is not None else None
    results = [None] * len(items)
    _fallback_stats["pairs_total"] += len(items)
    infos = []
    for idx, (g1, g2, model, scores) in enumerate(items):
        info = _prep_pair(idx, g1, g2, model, scores)
        if isinstance(info, str):
            _fallback_stats[info] += 1
        else:
            infos.append(info)
    if timers is not None:
        timers("prep")

    # split a batch whose device footprint would exceed the budget:
    # recursive halving down to single pairs (sorted by size, so the
    # halves are shape-homogeneous)
    ndev = mesh.size if mesh is not None else 1
    launches = []
    stack = [sorted(infos, key=lambda p: -(p.n1 + p.n2))] if infos else []
    while stack:
        chunk = stack.pop()
        if _launch_bytes(chunk, ndev) <= _device_budget():
            launches.append(chunk)
        elif len(chunk) > 1:
            half = len(chunk) // 2
            stack.append(chunk[half:])
            stack.append(chunk[:half])
        else:
            _fallback_stats["fb_size"] += 1

    outs = []
    for chunk in launches:
        flat, packed, Lm = _launch(chunk, interpret, timers, mesh=mesh)
        outs.append((flat, np.asarray(packed), Lm))   # fetch
    if timers is not None:
        timers("fetch")

    from .backtrack import mark_alternative_path

    for flat, packed, Lm in outs:
        meta_lo = 2 * Lm
        ev_lo = meta_lo + 16
        metah = packed[:, meta_lo:ev_lo].view(np.float32)
        for k, info in enumerate(flat):
            if info is None:
                continue
            fail = metah[k, META_FAIL]
            if fail != 0.0:
                _fallback_stats["fb_rep" if fail == FAIL_EVENTS
                                else "fb_chase"] += 1
                continue
            ln = int(metah[k, META_LEN])
            ntr = int(packed[k, ev_lo])
            walk1 = packed[k, :Lm][:ln].tolist()
            walk2 = packed[k, Lm:2 * Lm][:ln].tolist()
            if ntr:
                # splice the host markAlternativePath columns into the
                # walk-order mapping at the recorded positions (the host
                # appends them at exactly these points of its own walk)
                evb = packed[k, ev_lo + 1:ev_lo + 1 + 4 * EV_CAP]
                sides = evb[:EV_CAP]
                nxts = evb[EV_CAP:2 * EV_CAP]
                curs = evb[2 * EV_CAP:3 * EV_CAP]
                poss = evb[3 * EV_CAP:4 * EV_CAP]
                shift = 0
                for t in range(ntr):
                    tmp_m, tmp_o = [], []
                    g = info.g1 if sides[t] == 1 else info.g2
                    mark_alternative_path(int(nxts[t]), int(curs[t]), g,
                                          tmp_m, tmp_o)
                    at = int(poss[t]) + shift
                    if sides[t] == 1:
                        walk1[at:at] = tmp_m
                        walk2[at:at] = tmp_o
                    else:
                        walk2[at:at] = tmp_m
                        walk1[at:at] = tmp_o
                    shift += len(tmp_m)
            results[info.idx] = (walk1[::-1], walk2[::-1],
                                 np.float32(metah[k, META_SCORE]), ntr)
            _fallback_stats["pairs_device"] += 1
    return results


def align_pair_device(g1, g2, model, scores, interpret=False):
    """Fused device alignment of one pair (batch of 1)."""
    return align_pairs_device([(g1, g2, model, scores)],
                              interpret=interpret)[0]
