"""Seeded inputs of the engine's kernel entry points (the hybrid census,
the Lemma-8 pass and pivot select, the DFS step's branch half), shared by the
CPU tests against the reference and the card-only kernel tests; numpy
only, so the card machine, which has no JAX, can import it."""
import numpy as np


def one_bit(w, i):
    """A row of w uint32 words with only bit i set."""
    row = np.zeros(w, np.uint32)
    row[i // 32] = np.uint32(1) << np.uint32(i % 32)
    return row


def census_inputs(r, k, w, seed):
    """rows (r, k, w) and mask (r, w) uint32 words, in_p and in_x (r, k)
    bool: edge words, rows that hold the mask (pc == |mask|) and rows one
    mask bit short of it (pc == |mask| − 1), so both counts are nonzero.
    Given enough roots, root 0's mask is empty, root 1's the single top
    bit, and the last root's in_x is all false."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 2**32, (r, k, w), dtype=np.uint64) \
        .astype(np.uint32)
    for v in (0, 0xFFFFFFFF, 0x80000000):
        rows[rng.random(rows.shape) < 0.05] = np.uint32(v)
    mask = np.packbits(rng.random((r, w, 32)) < 0.5, axis=-1,
                       bitorder="little").view(np.uint32).reshape(r, w)
    if r > 1:
        mask[0] = 0
    if r > 2:
        mask[1] = 0
        mask[1, w - 1] = np.uint32(0x80000000)
    for i in range(r):
        bits = np.flatnonzero(np.unpackbits(mask[i].view(np.uint8),
                                            bitorder="little"))
        pick = rng.random(k)
        rows[i, pick < 0.3] |= mask[i]
        for kk in np.flatnonzero((pick >= 0.3) & (pick < 0.6)):
            if bits.size:
                rows[i, kk] = mask[i] & ~one_bit(w, int(rng.choice(bits)))
    in_p = rng.random((r, k)) < 0.5
    in_x = rng.random((r, k)) < 0.5
    if r > 1:
        in_x[-1] = False
    return rows, mask, in_p, in_x


def bits_of(words, n):
    """(..., W) uint32 words -> (..., n) bool: bit i of the words, i < n."""
    flat = np.unpackbits(np.ascontiguousarray(words).view(np.uint8),
                         axis=-1, bitorder="little")
    return flat[..., :n].astype(bool)


def hybrid_inputs(r, u, xc, w, seed):
    """The engine's operands of the hybrid census: a (r, u, w) and x_rows
    (r, xc, w) uint32 words, P and Xp (r, w), x_alive (r, max(ceil(xc /
    32), 1)) words with garbage past bit xc. P and Xp are disjoint and
    below U except on the roots from 4 on, whose P has bits past U where
    32·w > u. Root 0's P is empty, root 1's one bit, root 2's inside the
    neighbourhood of an alive X0 row (when xc > 0), and root 3's a clique
    of A (so n_full == |P|); a fifth of the other rows hold P."""
    assert r >= 4 and u <= 32 * w
    rng = np.random.default_rng(seed)
    rows, _, _, _ = census_inputs(r, u + xc, w, seed)
    a = np.ascontiguousarray(rows[:, :u])
    x_rows = np.ascontiguousarray(rows[:, u:])
    below = np.packbits(np.arange(32 * w) < u, bitorder="little") \
        .view(np.uint32)
    P = np.packbits(rng.random((r, w, 32)) < 0.4, axis=-1,
                    bitorder="little").view(np.uint32).reshape(r, w)
    P[:4] &= below
    Xp = np.packbits(rng.random((r, w, 32)) < 0.3, axis=-1,
                     bitorder="little").view(np.uint32).reshape(r, w)
    Xp &= below & ~P
    xcw = max(-(-xc // 32), 1)
    x_alive = rng.integers(0, 2**32, (r, xcw), dtype=np.uint64) \
        .astype(np.uint32)
    P[0] = 0
    P[1] = one_bit(w, u - 1)
    if xc:
        j = int(rng.integers(xc))
        P[2] &= x_rows[2, j]
        x_alive[2, j // 32] |= np.uint32(1) << np.uint32(j % 32)
    Xp &= ~P
    for i in range(r):
        for k in np.flatnonzero(rng.random(u + xc) < 0.2):
            row = a[i, k] if k < u else x_rows[i, k - u]
            row |= P[i]
    for k in np.flatnonzero(bits_of(P[3], u)):
        a[3, k] = (a[3, k] | P[3]) & ~one_bit(w, int(k))
    return a, x_rows, P, Xp, x_alive


def frame_inputs(r, u, xc, w, seed):
    """The engine's operands of the Lemma-8 pass and the pivot select:
    `hybrid_inputs`' a, x_rows, P, Xp and xal (garbage past bit xc) with
    Rb (r, w) and rsz (r,) int32, deg (r, u) and n_full (r,) int32 scores
    near the true degrees (negative ones too). Beyond hybrid_inputs' first
    four roots: root 4's rows all equal (every score ties), root 5's pool
    empty (P = Xp = 0), root 6's P inside N(v) ∪ {v} of a vertex v, which
    makes v full (deg |P| − 1) wherever Lemma 8 looks, and, given eight
    roots, root 7's pool the whole universe with given scores below −1 and
    no alive X0 row, so that the all-invalid X0 argmax (row 0, score −1)
    wins the pivot."""
    assert r >= 7
    rng = np.random.default_rng(seed + 1)
    a, x_rows, P, Xp, xal = hybrid_inputs(r, u, xc, w, seed)
    below = np.packbits(np.arange(32 * w) < u, bitorder="little") \
        .view(np.uint32)
    a[4] = a[4, :1]
    x_rows[4] = x_rows[4, :1]
    P[5] = 0
    Xp[5] = 0
    v = int(rng.integers(u))
    a[6, v] &= ~one_bit(w, v)
    P[6] = (a[6, v] | one_bit(w, v)) & below
    Xp[6] &= ~P[6]
    Rb = rng.integers(0, 2**32, (r, w), dtype=np.uint64).astype(np.uint32)
    Rb &= ~P
    rsz = rng.integers(0, 9, r).astype(np.int32)
    deg = np.zeros((r, u), np.int32)
    for i in range(r):
        both = a[i] & P[i]
        deg[i] = np.unpackbits(both.view(np.uint8).reshape(u, -1), axis=1) \
            .sum(1)
    deg += rng.integers(-2, 3, (r, u)).astype(np.int32)
    n_full = rng.integers(0, 3, r).astype(np.int32)
    if r > 7:
        Xp[7] = below & ~P[7]
        Rb[7] &= ~Xp[7]
        deg[7] = -5
        xal[7] = 0
    return a, x_rows, P, Xp, xal, Rb, rsz, deg, n_full


def branch_inputs(r, u, xc, w, d, seed):
    """The operands of the DFS step's branch half (`branch_step`):
    `hybrid_inputs`' a and x_rows, and a stack of d slots a root, P, B ⊆
    P, Xp and Rb (r, d, w) uint32 words, rsz (r, d) int32 and xal (r, d,
    max(ceil(xc / 32), 1)) words with garbage past bit xc and, on root 2,
    a dead word; depth (r,) int64 in [-1, d), live (r,) bool and a branch
    vertex w (r,) int32 below u. Root 0's slot has an empty B (w clamps),
    root 1 is dead at depth -1, roots 2 and 3 branch at bits 31 and 32 of
    B and w (where u has them), root 4 is not live; every other root is
    live."""
    assert r >= 5 and u <= 32 * w
    rng = np.random.default_rng(seed + 2)
    a, x_rows, _, _, _ = hybrid_inputs(r, u, xc, w, seed)
    below = np.packbits(np.arange(32 * w) < u, bitorder="little") \
        .view(np.uint32)

    def words(shape, density):
        return np.packbits(rng.random(shape + (32,)) < density, axis=-1,
                           bitorder="little").view(np.uint32).reshape(shape)
    P = words((r, d, w), 0.5) & below
    B = P & words((r, d, w), 0.5)
    Xp = words((r, d, w), 0.3) & below & ~P
    Rb = words((r, d, w), 0.1) & ~P
    rsz = rng.integers(1, 9, (r, d)).astype(np.int32)
    xcw = max(-(-xc // 32), 1)
    xal = rng.integers(0, 2**32, (r, d, xcw), dtype=np.uint64) \
        .astype(np.uint32)
    xal[2, :, 0] = 0
    depth = rng.integers(0, d, r).astype(np.int64)
    depth[1] = -1
    live = depth >= 0
    live[4] = False
    wv = rng.integers(0, u, r).astype(np.int32)
    B[0, depth[0]] = 0
    for i, bit in ((2, 31), (3, 32)):
        if bit < u:
            B[i, depth[i]] = one_bit(w, bit)
            P[i, depth[i]] |= B[i, depth[i]]
            Xp[i, depth[i]] &= ~B[i, depth[i]]
            wv[i] = bit
    return a, x_rows, P, B, Xp, Rb, rsz, xal, depth, live, wv
