"""Seeded inputs of the 'hybrid' census (`clique_counts`), shared by the
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
