"""The CUDA sweep's three-stage schedule, modelled in plain torch, against
the plain sweep and the JAX package's per-pair sweep, bit for bit.

``kernels/sfs/csrc/sfs_sweep.cu`` runs the sweep as (A) the sequential
sweep of the first K blocks, (B) a filter of every later row against
A's window, and (C) the sequential sweep of B's survivors, packed into
dense blocks when ``c_A + survivors <= wcap`` and kept in their original
blocks otherwise.  ``staged_sweep`` below models those stages as the
kernel runs them: flags read a chunk of rows at a time into a queue,
blocks taken off the queue where they end, a block that goes on past
the chunk carried over, C testing only the window rows appended after
B (the first ``resident`` of them from shared memory, the rest from the
output window), and B testing each CTA's rows against A's window in
tiles of ``tile`` rows, stopping when none is alive.  ``resident`` and
``tile`` default to the kernel's law at (d, block), which past d = 12
(the wide variant) shrinks the resident rows as the candidate block
grows.  Past d = 12 the packed branch is not C's: the wide variant runs
it on three grids across the card (R ranks the survivors, Q tests each
against the earlier ones in tiles of candidates and chunks of
references along the lower triangle, S appends the undominated ones by
rank), and ``_packed_wide`` models those.  It lives here and not in the
package: the package's plain version stays the straightforward sweep.
Compares flush subnormals to zeros of their sign, as the kernel and the
plain version do.  Tolerance: zero (every leaf through its bits, so
-0.0 must stay -0.0).

The footprint law of the kernel (``kernel.sweep_smem_bytes``) is held
here against the constants of the CUDA source and the card's per-CTA
limit.
"""

import _torch_threads  # noqa: F401  (one torch thread)
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.kernels.sfs import ops as jops
from repro_torch.core import sfs as tsfs
from repro_torch.core.dominance import SENTINEL
from repro_torch.kernels.dominance.ref import flush_subnormal
from repro_torch.kernels.sfs import kernel
from repro_torch.kernels.sfs import ops as tops

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "sfs" / "csrc" / "sfs_sweep.cu")
FILTER_ROWS = 256 * 2        # stage B's rows a CTA (kFilterRows)


def _pairs(refs, x):
    """(R, C) bool: row j of ``refs`` (R, d) dominates ``x[i]`` (C, d)."""
    refs, x = flush_subnormal(refs), flush_subnormal(x)
    le = (refs[:, None, :] <= x[None]).all(-1)
    lt = (refs[:, None, :] < x[None]).any(-1)
    return le & lt


def _dominated(refs, x):
    """(C,) bool: some row of ``refs`` dominates ``x[i]``."""
    return _pairs(refs, x).any(0)


def _seq(pts, flags, r0, r1, win, wmask, count, skip, packed, block, wcap,
         chunk, resident):
    """Stage A or C on one partition: the set rows of [r0, r1), read
    ``chunk`` flags at a time; returns the count.  The window rows after
    ``skip`` are tested in two parts, the ``resident`` rows kept in shared
    memory and the rest read from the window."""
    queue = []
    n = r1 - r0
    for c0 in range(0, n, chunk):
        queue += [r0 + j for j in range(c0, min(c0 + chunk, n))
                  if flags[j]]
        last = c0 + chunk >= n
        read_end = r0 + min(c0 + chunk, n)
        s = 0
        while s < len(queue):
            first = queue[s]
            lim = min(block, len(queue) - s)
            if packed:
                nb = lim
                ready = nb == block or last
            else:
                nb = sum(queue[s + t] // block == first // block
                         for t in range(lim))
                ready = (s + nb < len(queue) or last
                         or (first // block + 1) * block <= read_end)
            if not ready:
                break
            x = pts[queue[s:s + nb]]
            live = min(count, wcap)
            res_end = min(live, skip + resident)
            dom = _dominated(win[skip:res_end], x)
            dom |= _dominated(win[res_end:live], x)
            dom |= (_pairs(x, x) & torch.ones(nb, nb, dtype=torch.bool)
                    .triu(1)).any(0)
            for i in range(nb):
                if not dom[i]:
                    if count < wcap:
                        win[count] = x[i]
                        wmask[count] = True
                    count += 1
            s += nb
        queue = queue[s:]
    return count


def _filter(x, mask, w, tile):
    """Stage B on one partition's rows ``x``: each CTA of
    ``FILTER_ROWS`` rows against the window ``w`` a tile at a time, until
    none of its rows is alive."""
    alive = mask.clone()
    for c0 in range(0, x.shape[0], FILTER_ROWS):
        a = alive[c0:c0 + FILTER_ROWS]
        for t0 in range(0, w.shape[0], tile):
            if not bool(a.any()):
                break
            a &= ~_dominated(w[t0:t0 + tile], x[c0:c0 + FILTER_ROWS])
    return alive


def _tri_root(u):
    """The largest c with c (c + 1) / 2 <= u."""
    return (math.isqrt(8 * u + 1) - 1) // 2


def _packed_wide(x, alive, r0, win, wmask, count, *, tile, pair_rows,
                 ctas):
    """Grids R, Q and S on one partition that packs (d > 12); returns the
    count.  R: the survivors in rank order.  Q: item w of ``g`` x the
    lower triangle of candidate tiles, tile c against the references
    ``[h * chunk, +chunk)`` before its end, ``chunk = pair_rows / g``
    with ``g`` the smallest power of two up to 8 that makes the items at
    least ``ctas``; references staged ``tile`` at a time, each counting
    only before its candidate; a candidate marked when its item starts
    is skipped.  S: the undominated survivors at ``count + rank``."""
    v = x[r0:][alive]
    n = v.shape[0]
    dom = torch.zeros(n, dtype=torch.bool)
    tiles = -(-n // pair_rows)
    tri = tiles * (tiles + 1) // 2
    g = 1
    while g < kernel._PAIR_MAX_SPLIT and g * tri < ctas:
        g *= 2
    chunk = pair_rows // g
    for w in range(g * tri if n >= 2 else 0):
        c = _tri_root(w // g)
        c0 = c * pair_rows
        lo = (w - g * (c * (c + 1) // 2)) * chunk
        hi = min(lo + chunk, c0 + pair_rows, n)
        if lo >= hi:
            continue
        i = torch.arange(c0, min(c0 + pair_rows, n))
        opened = (i > lo) & ~dom[i]
        todo = opened.clone()
        for t0 in range(lo, hi, tile):
            if not bool(todo.any()):
                break
            j = torch.arange(t0, min(t0 + tile, hi))
            todo &= ~(_pairs(v[j], v[i]) & (j[:, None] < i[None])).any(0)
        dom[i[opened & ~todo]] = True
    kept = v[~dom]
    win[count:count + kept.shape[0]] = kept
    wmask[count:count + kept.shape[0]] = True
    return count + kept.shape[0]


def staged_sweep(pts_s, mask_s, *, block, wcap, sentinel, k, chunk=8192,
                 guard=True, resident=None, tile=None, pair_rows=None,
                 ctas=None):
    """The kernel's schedule with a prefix of ``k`` blocks.  Returns the
    sweep's three outputs and, per partition, stage A's count ``c_a``,
    B's ``survivors`` and the ``branch`` it took (None where A covered
    the sweep; past d = 12 the packed branch runs ``_packed_wide``, not
    C).  ``guard=False`` packs whatever the count: that is wrong under
    overflow.  ``resident`` (A and C's resident window rows) and ``tile``
    (B's and Q's tile rows) default to the kernel's law, ``pair_rows``
    (Q's candidate tile) and ``ctas`` (Q's grid a partition) to the
    kernel's on a card of 132 multiprocessors."""
    p, npad, d = pts_s.shape
    if resident is None:
        resident = kernel.resident_rows(d, block)
    if tile is None:
        tile = kernel.filter_tile_rows(d)
    if pair_rows is None:
        pair_rows = kernel._PAIR_ROWS
    if ctas is None:
        ctas = -(-132 * kernel._PAIR_WAVES * min(p, kernel._PAIR_PARTS) // p)
    r0 = min(npad, k * block)
    window = torch.full((p, wcap, d), sentinel, dtype=pts_s.dtype)
    wmask = torch.zeros((p, wcap), dtype=torch.bool)
    count = torch.zeros((p,), dtype=torch.int32)
    info = {"c_a": [], "survivors": [], "branch": []}
    for i in range(p):
        x, w, wm = pts_s[i], window[i], wmask[i]
        c = _seq(x, mask_s[i], 0, r0, w, wm, 0, 0, False, block, wcap, chunk,
                 resident)
        info["c_a"].append(c)
        b, n_alive = None, 0
        if r0 < npad:
            t = min(tile, r0, wcap)         # at most the prefix window
            alive = _filter(x[r0:], mask_s[i, r0:], w[:min(c, wcap)],
                            max(t, 1))
            n_alive = int(alive.sum())
            packed = c + n_alive <= wcap or not guard
            b = "packed" if packed else "original"
            if packed and d > kernel.NARROW_D:
                c = _packed_wide(x, alive, r0, w, wm, c, tile=tile,
                                 pair_rows=pair_rows, ctas=ctas)
            else:
                c = _seq(x, alive, r0, npad, w, wm, c, min(c, wcap), packed,
                         block, wcap, chunk, resident)
        count[i] = c
        info["survivors"].append(n_alive)
        info["branch"].append(b)
    return (window, wmask, count), info


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_leaves_equal(got, want, ctx):
    for g, w, name in zip(got, want, ("window", "mask", "count")):
        np.testing.assert_array_equal(_bits(g), _bits(w),
                                      err_msg=f"{name} differs {ctx}")


def _check(pts_s, mask_s, *, block, wcap, k, chunk=8192, **sizes):
    """The staged model against the plain sweep and JAX's per-pair sweep;
    returns the model's branches.  ``sizes``: the model's ``resident``
    and ``tile``, when not the law's."""
    kw = dict(block=block, wcap=wcap, sentinel=SENTINEL)
    got, info = staged_sweep(pts_s, mask_s, k=k, chunk=chunk, **sizes, **kw)
    got = [t.numpy() for t in got]
    want = [t.numpy() for t in tops.sfs_sweep_torch(pts_s, mask_s, **kw)]
    ctx = f"(k={k}, chunk={chunk}, block={block}, wcap={wcap})"
    _assert_leaves_equal(got, want, f"from the plain sweep {ctx}")
    ref = jops.sfs_sweep(jnp.asarray(pts_s.numpy()),
                         jnp.asarray(mask_s.numpy()), spec="perpair", **kw)
    _assert_leaves_equal(got, [np.asarray(r) for r in ref],
                         f"from JAX perpair {ctx}")
    return info["branch"]


def _sorted(pts, mask, capacity, block):
    """The sweep's input as the port's presort makes it."""
    pts_p, mask_p, block, wcap = tsfs.sweep_inputs(
        torch.from_numpy(pts), torch.from_numpy(mask), capacity=capacity,
        block=block)
    return pts_p, mask_p, block, wcap


# Six rows in three blocks of 2, already in score order: a and b kept
# (an antichain); u kept (neither dominates it); v, which only u
# dominates, in the next block; the rest dominated by a.  With wcap = 2
# the window is [a, b] from the first block on, so the reference counts
# u and v (4 keeps): v's block holds no dominator of v.  Packed, u and v
# share a block and v falls (3 keeps).
WITNESS = np.asarray([[[0.0, 5.0], [5.0, 0.5], [3.0, 3.0], [1.0, 6.0],
                       [3.5, 4.0], [2.0, 7.0]]], np.float32)


def _witness():
    return torch.from_numpy(WITNESS), torch.ones((1, 6), dtype=torch.bool)


def test_overflow_original_blocks():
    """c_A + survivors > wcap: C keeps the original blocks, and the count
    is the reference's."""
    x, m = _witness()
    branch = _check(x, m, block=2, wcap=2, k=1)
    assert branch == ["original"]
    assert int(tops.sfs_sweep_torch(x, m, block=2, wcap=2,
                                    sentinel=SENTINEL)[2][0]) == 4


def test_packing_without_the_guard_changes_the_count():
    """The witness that the guard is needed: packed regardless, the
    window is the same but the count is not."""
    x, m = _witness()
    kw = dict(block=2, wcap=2, sentinel=SENTINEL, k=1)
    good, _ = staged_sweep(x, m, **kw)
    bad, info = staged_sweep(x, m, guard=False, **kw)
    assert info["branch"] == ["packed"]
    assert torch.equal(bad[0], good[0]) and torch.equal(bad[1], good[1])
    assert (int(good[2][0]), int(bad[2][0])) == (4, 3)


def test_packed_and_original_branches_in_one_batch():
    """Partition 0 overflows (original blocks); partition 1 packs, and its
    count lands exactly on wcap (the guard's edge); partition 2 packs
    with room to spare."""
    rng = np.random.default_rng(4)
    anti = rng.random((120, 3)).astype(np.float32) + 1e-3
    anti /= anti.sum(-1, keepdims=True)              # an antichain
    pts = np.stack([anti, anti, rng.random((120, 3)).astype(np.float32)])
    mask = np.ones((3, 120), bool)
    mask[1, 104:] = False                            # 104 valid rows
    pts_p, mask_p, block, wcap = _sorted(pts, mask, 104, 8)
    assert (block, wcap, pts_p.shape[1]) == (8, 104, 120)
    for k in (1, 3):
        for chunk in (8, 20, 8192):
            branch = _check(pts_p, mask_p, block=block, wcap=wcap, k=k,
                            chunk=chunk)
            assert branch == ["original", "packed", "packed"], (k, branch)
    got = tops.sfs_sweep_torch(pts_p, mask_p, block=block, wcap=wcap,
                               sentinel=SENTINEL)[2]
    assert got.tolist()[:2] == [120, 104]


def test_score_tie_dominators():
    """Rows whose f32 scores tie although one dominates the other, so a
    dominator can sit after its victim in sorted order."""
    rng = np.random.default_rng(8)
    pts = rng.integers(0, 6, (2, 300, 3)).astype(np.float32)
    pts[..., 0] += 1e8
    mask = rng.random((2, 300)) > 0.1
    pts_p, mask_p, block, wcap = _sorted(pts, mask, 300, 8)
    for k in (0, 1, 3):
        for chunk in (5, 64, 8192):
            _check(pts_p, mask_p, block=block, wcap=wcap, k=k, chunk=chunk)
    # overflow on the same data
    pts_p, mask_p, block, wcap = _sorted(pts, mask, 4, 2)
    for k in (1, 2):
        _check(pts_p, mask_p, block=block, wcap=wcap, k=k, chunk=7)


def test_negative_zero_and_masked_rows():
    pts = np.asarray([[[-0.0, 0.5], [0.25, 0.25], [0.5, -0.0],
                       [0.75, -1.0], [1.0, 1.0], [0.125, 0.625],
                       [-0.0, 0.75], [0.5, 0.5]]], np.float32)
    mask = np.asarray([[True, True, True, True, False, True, True, True]])
    pts_p, mask_p, block, wcap = _sorted(pts, mask, 8, 2)
    for k in (0, 1, 2):
        _check(pts_p, mask_p, block=block, wcap=wcap, k=k, chunk=3)
    got, _ = staged_sweep(pts_p, mask_p, block=block, wcap=wcap,
                          sentinel=SENTINEL, k=1)
    assert bool(torch.signbit(got[0][got[1]]).any())


@pytest.mark.parametrize("block", [1, 2])
def test_blocks_of_one_and_two(block):
    rng = np.random.default_rng(block)
    pts = (rng.integers(0, 5, (2, 60, 3)) / 5).astype(np.float32)
    mask = rng.random((2, 60)) > 0.2
    for cap in (60, 5):
        pts_p, mask_p, blk, wcap = _sorted(pts, mask, cap, block)
        for k in (0, 1, 4):
            _check(pts_p, mask_p, block=blk, wcap=wcap, k=k, chunk=7)


def test_empty_input():
    """n == 0: one all-masked row per partition."""
    pts_p, mask_p, block, wcap = _sorted(np.zeros((2, 0, 3), np.float32),
                                         np.zeros((2, 0), bool), 4, 8)
    for k in (0, 1):
        assert _check(pts_p, mask_p, block=block, wcap=wcap, k=k) in (
            [None, None], ["packed", "packed"])


def test_prefix_covers_the_sweep():
    """K x block >= npad: stage A is the whole sweep."""
    rng = np.random.default_rng(12)
    pts = rng.random((3, 50, 4)).astype(np.float32)
    mask = rng.random((3, 50)) > 0.2
    pts_p, mask_p, block, wcap = _sorted(pts, mask, 16, 16)
    assert _check(pts_p, mask_p, block=block, wcap=wcap,
                  k=4) == [None] * 3


def test_all_masked_partition():
    rng = np.random.default_rng(13)
    pts = rng.random((3, 90, 3)).astype(np.float32)
    mask = rng.random((3, 90)) > 0.3
    mask[1] = False
    pts_p, mask_p, block, wcap = _sorted(pts, mask, 90, 8)
    _check(pts_p, mask_p, block=block, wcap=wcap, k=2, chunk=16)


def test_antichain_filter_drops_nothing():
    """On an antichain B drops nothing and C walks every later row."""
    rng = np.random.default_rng(14)
    x = rng.random((2, 200, 4)).astype(np.float32) + 1e-3
    x /= x.sum(-1, keepdims=True)
    pts_p, mask_p, block, wcap = _sorted(x, np.ones((2, 200), bool), 200, 16)
    for wc, want in ((wcap, "packed"), (64, "original")):
        assert _check(pts_p, mask_p, block=block, wcap=wc, k=2,
                      chunk=40) == [want, want]
        _, info = staged_sweep(pts_p, mask_p, block=block, wcap=wc,
                               sentinel=SENTINEL, k=2)
        assert info["survivors"] == [168, 168]           # all 200 - 32


@pytest.mark.parametrize("d", [16, 64])
def test_wide_d_at_the_laws_sizes(d):
    """The wide variant's sizes at d = 16 and 64, block 512: an antichain
    whose window outgrows the resident rows (251 at d = 64; at d = 16,
    whose 2,048 rows it does not reach, also a resident window of 40
    rows), B's tiles of filter_tile_rows(d) rows over a prefix window of
    512, and overflow; then tie-heavy rows with -0.0."""
    rng = np.random.default_rng(d)
    x = rng.random((2, 800, d)).astype(np.float32) + 1e-3
    x /= x.sum(-1, keepdims=True)                     # an antichain
    mask = rng.random((2, 800)) > 0.05
    pts_p, mask_p, block, wcap = _sorted(x, mask, 800, 512)
    assert kernel.resident_rows(d, block) == {16: 2048, 64: 251}[d]
    assert kernel.filter_tile_rows(d) == 32_768 // (4 * d)
    for sizes in ({}, dict(resident=40)):
        assert _check(pts_p, mask_p, block=block, wcap=wcap, k=1,
                      **sizes) == ["packed"] * 2
        assert _check(pts_p, mask_p, block=block, wcap=512, k=1,
                      **sizes) == ["original"] * 2
    t = (rng.integers(0, 3, (2, 600, d)) / 3).astype(np.float32)
    t[rng.random(t.shape) < 0.05] = -0.0
    pts_p, mask_p, block, wcap = _sorted(t, mask[:, :600], 600, 256)
    for k in (1, 2):
        _check(pts_p, mask_p, block=block, wcap=wcap, k=k, chunk=300)


# -- the packed branch past d = 12: grids R, Q and S ------------------------

PACKED_D = (13, 16, 32, 64, 128)
# Q's candidate tile, grid and staged tile: one tile of 512 and the
# card's grid (the defaults); tiles of 8 on one CTA (no split) and on
# 1,000 (chunks of one reference); tiles of 16 on 5 CTAs in staged tiles
# of 3 rows
PACKED_VARIANTS = ({}, dict(pair_rows=8, ctas=1), dict(pair_rows=8,
                   ctas=1000), dict(pair_rows=16, ctas=5, tile=3))


def _wide_rows(rng, kind, p, n, d):
    if kind == "scoretie":     # f32 score ties: a later row may dominate
        x = rng.integers(0, 3, (p, n, d)).astype(np.float32)
        x[..., 0] += 1e8
    elif kind == "duplicates":
        x = np.repeat(rng.random((p, -(-n // 3), d)), 3, 1)[:, :n]
    elif kind == "signs":      # -0.0 against +0.0, subnormals against 0
        x = rng.choice(np.asarray([0.0, -0.0, 1e-40, -1e-40, 0.5, 1.0],
                                  np.float32), (p, n, d))
    elif kind == "correlated":  # a small skyline at any d
        x = np.round((rng.random((p, n, 1)) + 0.25 * rng.random((p, n, d)))
                     * 16) / 16
    else:                      # graded: rows dominate one another at any d
        x = np.round((0.5 * rng.random((p, n, 1)) + rng.random((p, n, d)))
                     * 8) / 8
    return x.astype(np.float32)


def _check_wide(pts_s, mask_s, *, block, wcap, k):
    """Every variant of the model against the plain sweep and JAX's
    per-pair sweep (computed once); returns the model's info."""
    kw = dict(block=block, wcap=wcap, sentinel=SENTINEL)
    want = [t.numpy() for t in tops.sfs_sweep_torch(pts_s, mask_s, **kw)]
    ref = jops.sfs_sweep(jnp.asarray(pts_s.numpy()),
                         jnp.asarray(mask_s.numpy()), spec="perpair", **kw)
    _assert_leaves_equal(want, [np.asarray(r) for r in ref],
                         f"plain sweep from JAX perpair (wcap={wcap})")
    for v in PACKED_VARIANTS:
        got, info = staged_sweep(pts_s, mask_s, k=k, **v, **kw)
        _assert_leaves_equal([t.numpy() for t in got], want,
                             f"(k={k}, wcap={wcap}, model {v})")
    return info


@pytest.mark.parametrize("d", PACKED_D)
def test_packed_branch_wide(d):
    """The packed branch on R, Q and S, bit for bit: score ties where a
    later row dominates an earlier one, duplicates, -0.0 against +0.0
    and subnormals, masked and sentinel rows (npad past n), an all-masked
    partition and one whose prefix dominates every later row (zero
    survivors both), survivor counts that are no multiple of a tile."""
    rng = np.random.default_rng(2900 + d)
    counts = []
    for kind in ("scoretie", "duplicates", "signs", "graded"):
        x = _wide_rows(rng, kind, 3, 150, d)
        mask = rng.random((3, 150)) > 0.15
        mask[1] = False                          # all masked
        x[2, 0] = -1.0                           # dominates all of row 2's
        mask[2, 0] = True
        pts_p, mask_p, block, wcap = _sorted(x, mask, 150, 8)
        assert pts_p.shape[1] == 152             # two sentinel rows
        info = _check_wide(pts_p, mask_p, block=block, wcap=wcap, k=2)
        assert info["branch"] == ["packed"] * 3, (kind, info)
        assert info["survivors"][1:] == [0, 0], (kind, info)
        counts.append(info["survivors"][0])
        if kind == "signs":  # a signed zero kept in the window by R and S
            got, _ = staged_sweep(pts_p, mask_p, block=block, wcap=wcap,
                                  sentinel=SENTINEL, k=2)
            kept = got[0][0, info["c_a"][0]:int(got[2][0])]
            assert bool((torch.signbit(kept) & (kept == 0)).any())
    assert any(n > 16 and n % 8 for n in counts), counts


@pytest.mark.parametrize("d", PACKED_D)
def test_packed_branch_wide_at_wcap(d):
    """c_A + survivors == wcap packs (R, Q, S run), wcap + 1 keeps the
    original blocks (C runs), each bit for bit; then one call with an
    overflowing antichain, a packed partition and an all-masked one."""
    rng = np.random.default_rng(2950 + d)
    x = _wide_rows(rng, "graded", 1, 120, d)
    pts_p, mask_p, block, _ = _sorted(x, np.ones((1, 120), bool), 120, 4)
    _, info = staged_sweep(pts_p, mask_p, block=block, wcap=120,
                           sentinel=SENTINEL, k=2)
    edge = info["c_a"][0] + info["survivors"][0]
    assert info["survivors"][0] > 1 and edge - 1 >= info["c_a"][0]
    assert _check_wide(pts_p, mask_p, block=block, wcap=edge,
                       k=2)["branch"] == ["packed"]
    assert _check_wide(pts_p, mask_p, block=block, wcap=edge - 1,
                       k=2)["branch"] == ["original"]
    anti = rng.random((100, d)).astype(np.float32) + 1e-3
    anti /= anti.sum(-1, keepdims=True)
    pts = np.stack([anti, _wide_rows(rng, "correlated", 1, 100, d)[0],
                    _wide_rows(rng, "signs", 1, 100, d)[0]])
    mask = np.ones((3, 100), bool)
    mask[2] = False
    pts_p, mask_p, block, wcap = _sorted(pts, mask, 60, 4)
    assert _check_wide(pts_p, mask_p, block=block, wcap=wcap,
                       k=3)["branch"] == ["original", "packed", "packed"]


def _law_before(d, block):
    """The law of the tree before the packed branch's grids: A, B, C."""
    law = kernel.sweep_smem_bytes(d, block)
    return {k: law[k] for k in ("prefix", "filter", "survivors")}


def test_check_args_accepts_what_it_accepted_before():
    """The grids R, Q and S fit wherever A, B and C fit, so check_args
    takes the same (d, block) set as before them: every d to 128 at
    blocks to 256, to 89 at 512, to 1,480 at block 1, and no more."""
    lim = kernel.SMEM_LIMIT
    for d in range(1, 1601):
        for block in (1, 2, 64, 255, 256, 257, 349, 350, 511, 512):
            before = max(_law_before(d, block).values()) <= lim
            after = max(kernel.sweep_smem_bytes(d, block).values()) <= lim
            assert before == after, (d, block)
            if d <= 128 and block <= 256 or d <= 89 or (d <= 1480
                                                         and block == 1):
                assert after, (d, block)
    for d in (1, 12, 13, 16, 64, 88, 89, 90, 128, 129, 200, 1480, 1481):
        assert kernel.largest_block(d) == max(
            [0] + [b for b in range(1, 513)
                   if max(_law_before(d, b).values()) <= lim]), d
    assert (kernel.largest_block(89), kernel.largest_block(90),
            kernel.largest_block(1480), kernel.largest_block(1481)) == (
        512, 510, 1, 0)
    for d, block, ok in ((128, 256, True), (89, 512, True), (90, 512, False),
                         (1480, 1, True), (1481, 1, False)):
        pts = torch.rand(1, block, d)
        mask = torch.ones(1, block, dtype=torch.bool)
        if ok:
            kernel.check_args(pts, mask, block, 64)
        else:
            with pytest.raises(ValueError, match="shared memory"):
                kernel.check_args(pts, mask, block, 64)


@settings(max_examples=25, deadline=None, database=None)
@given(st.integers(1, 3), st.integers(0, 70), st.integers(1, 5),
       st.integers(0, 4), st.sampled_from([1, 2, 3, 8, 16]),
       st.integers(0, 4), st.sampled_from([1, 5, 16, 8192]),
       st.integers(0, 2 ** 31 - 1))
def test_hypothesis_schedule(p, n, d, kind, blk, k, chunk, seed):
    """Property: the staged schedule is bit for bit the plain sweep and
    JAX's per-pair sweep, over ties, score ties between dominating rows,
    -0.0, masked rows, n == 0, small blocks, any K, any chunk, and
    capacities from 1 up (overflow included)."""
    rng = np.random.default_rng(seed)
    if kind == 0:
        pts = rng.random((p, n, d)).astype(np.float32)
    elif kind == 1:          # heavy ties and -0.0
        pts = (rng.integers(0, 3, (p, n, d)) / 3).astype(np.float32)
        pts[rng.random((p, n, d)) < 0.1] = -0.0
    elif kind == 2:          # f32 score ties between dominating rows
        pts = rng.integers(0, 4, (p, n, d)).astype(np.float32)
        pts[..., 0] += 1e8
    elif kind == 3:          # an antichain
        pts = rng.random((p, n, d)).astype(np.float32) + 1e-3
        pts /= pts.sum(-1, keepdims=True)
    else:                    # duplicates
        pts = np.repeat(rng.random((p, -(-n // 3), d)), 3, 1)[:, :n]
        pts = pts.astype(np.float32)
    mask = rng.random((p, n)) > 0.25
    cap = int(rng.integers(1, n + 2))
    pts_p, mask_p, block, wcap = _sorted(pts, mask, cap, blk)
    _check(pts_p, mask_p, block=block, wcap=wcap, k=k, chunk=chunk)


# -- the footprint law ----------------------------------------------------

def _source_constants():
    src = SOURCE.read_text()
    return {name: int(val) for name, val in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}


def test_law_mirrors_the_source():
    """The law's constants are the CUDA source's."""
    c = _source_constants()
    src = SOURCE.read_text()
    assert c["kSeqThreads"] == kernel.MAX_BLOCK == kernel._SEQ_THREADS
    assert kernel._QUEUE_CAP == c["kSeqThreads"] * c["kFlagsPerThread"] + \
        c["kSeqThreads"]
    assert c["kResidentBytes"] == kernel._RESIDENT_BYTES
    assert c["kFilterTileBytes"] == kernel._FILTER_TILE_BYTES
    assert c["kSmemLimit"] == kernel.SMEM_LIMIT
    assert c["kNarrowD"] == kernel.NARROW_D
    assert c["kLaneRows"] == kernel._LANE_ROWS
    assert c["kFilterThreads"] * c["kFilterPer"] == FILTER_ROWS
    assert re.search(r"kSeqFixedBytes =\s+4LL \* kQueueCap \+ 4LL \* 32 \+ "
                     r"4LL \* kSeqThreads;", src)
    assert kernel._SEQ_FIXED == (4 * kernel._QUEUE_CAP + 4 * 32
                                 + 4 * kernel._SEQ_THREADS)
    # the packed branch's grids past d = 12
    assert re.search(r"kRankRows = kRankThreads \* kFlagsPerThread;", src)
    assert kernel._RANK_ROWS == c["kRankThreads"] * c["kFlagsPerThread"]
    assert re.search(r"kPairRows = kFilterThreads \* kPairPer;", src)
    assert kernel._PAIR_ROWS == c["kFilterThreads"] * c["kPairPer"]
    assert c["kPairWaves"] == kernel._PAIR_WAVES
    assert c["kPairParts"] == kernel._PAIR_PARTS
    assert c["kPairMaxSplit"] == kernel._PAIR_MAX_SPLIT
    assert re.search(r"kRankSmemBytes = 4LL \* kRankRows \+ 4LL \* 32;",
                     src)
    assert re.search(r"pairs_smem_bytes\(int d\) \{ return 4LL \* d \* "
                     r"filter_tile_rows\(d\); \}", src)


WIDE_D = (13, 16, 20, 24, 32, 48, 64, 96, 128)


@pytest.mark.parametrize("d", list(range(1, 13)) + list(WIDE_D))
def test_law_within_the_limit(d):
    """At every d up to 128 and every block up to 256, and at every d
    up to 64 and the largest block, each stage's CTA fits the 232,448
    bytes one CTA may take on sm_90.  Up to d = 12 the resident window is
    kResidentBytes; past it, what the candidate block leaves of the
    limit, at most kResidentBytes and at least kLaneRows rows."""
    blocks = (1, 2, 255, 256) + ((kernel.MAX_BLOCK,) if d <= 64 else ())
    for block in blocks:
        law = kernel.sweep_smem_bytes(d, block)
        assert set(law) == {"prefix", "filter", "survivors"} | (
            {"rank", "pairs"} if d > 12 else set())
        if d > 12:
            assert law["rank"] == 4 * 4096 + 4 * 32
            assert law["pairs"] == 4 * d * max(32, 32_768 // (4 * d))
        assert all(0 < v <= kernel.SMEM_LIMIT for v in law.values()), law
        cap = 131_072 // (4 * d)
        room = (kernel.SMEM_LIMIT - 4 * (512 * 16 + 512) - 4 * 32 - 4 * 512
                - 4 * d * block) // (4 * d)
        resident = cap if d <= 12 else min(cap, room)
        assert resident >= 32
        assert kernel.resident_rows(d, block) == resident
        assert law["prefix"] == law["survivors"] == (
            4 * d * block + 4 * (512 * 16 + 512) + 4 * 32 + 4 * 512
            + 4 * d * resident)
        tile = max(32, 32_768 // (4 * d))
        assert law["filter"] == 4 * d * min(
            tile, kernel.prefix_rows(2 ** 31 - 1, block))
    # the filter tile is at most the prefix window
    assert kernel.sweep_smem_bytes(d, 256, wcap=10)["filter"] == 40 * d
    assert kernel.sweep_smem_bytes(d, 256, wcap=0)["filter"] == 0
    assert kernel.largest_block(d) >= (512 if d <= 64 else 256)


@pytest.mark.parametrize("d,block", [(128, 350), (200, 256), (90, 512),
                                     (1481, 1)])
def test_check_args_refuses_past_the_law(d, block):
    """check_args refuses exactly where the law exceeds the limit, and
    names the largest block that fits (a block of one does not fit past
    d = 1,480)."""
    most = kernel.largest_block(d)
    assert most == {128: 349, 200: 212, 90: 510, 1481: 0}[d]
    assert max(kernel.sweep_smem_bytes(d, block).values()) > kernel.SMEM_LIMIT
    pts = torch.rand(1, block, d)
    mask = torch.ones(1, block, dtype=torch.bool)
    fits = (f"the largest block that fits at d={d} is {most}" if most
            else f"no block fits at d={d}")
    with pytest.raises(ValueError, match=fits):
        kernel.check_args(pts, mask, block, 64)
    if most:
        assert max(kernel.sweep_smem_bytes(d, most).values()) <= \
            kernel.SMEM_LIMIT
        kernel.check_args(torch.rand(1, most, d),
                          torch.ones(1, most, dtype=torch.bool), most, 64)


def test_check_args_raises_above_the_limit(monkeypatch):
    pts = torch.rand(2, 64, 4)
    mask = torch.ones(2, 64, dtype=torch.bool)
    kernel.check_args(pts, mask, 32, 64)
    monkeypatch.setattr(kernel, "SMEM_LIMIT",
                        kernel.sweep_smem_bytes(4, 32)["prefix"] - 1)
    with pytest.raises(ValueError, match="shared memory"):
        kernel.check_args(pts, mask, 32, 64)


def test_check_args_caps_the_partitions():
    """Stage B's grid holds the partitions on its y axis in slices of
    65,535, so more partitions than one slice pass; the cap is the
    x axis of stages A and C (2^31 - 1)."""
    n = 70_000
    kernel.check_args(torch.rand(n, 1, 2), torch.ones(n, 1, dtype=torch.bool),
                      1, 1)
    assert kernel.MAX_PARTS == 2 ** 31 - 1
    # a zero-stride view: the partition count is refused before the
    # layout is looked at, and nothing of that size is allocated
    big = kernel.MAX_PARTS + 1
    with pytest.raises(ValueError, match="P <="):
        kernel.check_args(torch.rand(1, 1, 2).expand(big, 1, 2),
                          torch.ones(1, 1, dtype=torch.bool).expand(big, 1),
                          1, 1)


def test_prefix_rows():
    assert kernel.prefix_rows(10 ** 6, 256) == 4096       # K = 16 blocks
    assert kernel.prefix_rows(10 ** 6, 300) == 4200       # whole blocks
    assert kernel.prefix_rows(1000, 200) == 1000          # A covers it
    assert kernel.prefix_rows(10 ** 6, 256, rows=0) == 0


@pytest.mark.parametrize("npad,d,want", [
    (10 ** 7, 4, 4096), (1000, 12, 4096),       # up to d = 12: PREFIX_ROWS
    (4608, 16, 512), (65_536, 16, 512),         # past it: npad / 256 ...
    (262_144, 13, 1024), (524_288, 32, 2048),
    (1_048_576, 16, 4096), (2 ** 31 - 1, 128, 4096)])  # ... in [512, 4096]
def test_entry_prefix(npad, d, want):
    """The entry's prefix: PREFIX_ROWS up to d = 12 (unchanged), past it
    npad / 256 rows within [512, 4096], which the sweep's law takes at
    its largest (4096 rows)."""
    assert kernel.entry_prefix(npad, d) == want
    assert kernel.WIDE_PREFIX_ROWS[1] == kernel.PREFIX_ROWS
