"""The CUDA sweep's three-stage schedule, modelled in plain torch, against
the plain sweep and the JAX package's per-pair sweep, bit for bit.

``kernels/sfs/csrc/sfs_sweep.cu`` runs the sweep as (A) the sequential
sweep of the first K blocks, (B) a filter of every later row against
A's window, and (C) the sequential sweep of B's survivors, packed into
dense blocks when ``c_A + survivors <= wcap`` and kept in their original
blocks otherwise.  ``staged_sweep`` below models those stages as the
kernel runs them: flags read a chunk of rows at a time into a queue,
blocks taken off the queue where they end, a block that goes on past
the chunk carried over, and C testing only the window rows appended
after B.  It lives here and not in the package: the package's plain
version stays the straightforward sweep.  Tolerance: zero (every leaf
through its bits, so -0.0 must stay -0.0).

The footprint law of the kernel (``kernel.sweep_smem_bytes``) is held
here against the constants of the CUDA source and the card's per-CTA
limit.
"""

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
from repro_torch.kernels.sfs import kernel
from repro_torch.kernels.sfs import ops as tops

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "sfs" / "csrc" / "sfs_sweep.cu")


def _pairs(refs, x):
    """(R, C) bool: row j of ``refs`` (R, d) dominates ``x[i]`` (C, d)."""
    le = (refs[:, None, :] <= x[None]).all(-1)
    lt = (refs[:, None, :] < x[None]).any(-1)
    return le & lt


def _dominated(refs, x):
    """(C,) bool: some row of ``refs`` dominates ``x[i]``."""
    return _pairs(refs, x).any(0)


def _seq(pts, flags, r0, r1, win, wmask, count, skip, packed, block, wcap,
         chunk):
    """Stage A or C on one partition: the set rows of [r0, r1), read
    ``chunk`` flags at a time; returns the count."""
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
            dom = _dominated(win[skip:live], x)
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


def staged_sweep(pts_s, mask_s, *, block, wcap, sentinel, k, chunk=8192,
                 guard=True):
    """The kernel's schedule with a prefix of ``k`` blocks.  Returns the
    sweep's three outputs and, per partition, stage A's count ``c_a``,
    B's ``survivors`` and the ``branch`` C took (None where A covered
    the sweep).  ``guard=False`` packs whatever the count: that is wrong
    under overflow."""
    p, npad, d = pts_s.shape
    r0 = min(npad, k * block)
    window = torch.full((p, wcap, d), sentinel, dtype=pts_s.dtype)
    wmask = torch.zeros((p, wcap), dtype=torch.bool)
    count = torch.zeros((p,), dtype=torch.int32)
    info = {"c_a": [], "survivors": [], "branch": []}
    for i in range(p):
        x, w, wm = pts_s[i], window[i], wmask[i]
        c = _seq(x, mask_s[i], 0, r0, w, wm, 0, 0, False, block, wcap, chunk)
        info["c_a"].append(c)
        b, n_alive = None, 0
        if r0 < npad:
            alive = mask_s[i, r0:] & ~_dominated(w[:min(c, wcap)], x[r0:])
            n_alive = int(alive.sum())
            packed = c + n_alive <= wcap or not guard
            b = "packed" if packed else "original"
            c = _seq(x, alive, r0, npad, w, wm, c, min(c, wcap), packed,
                     block, wcap, chunk)
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


def _check(pts_s, mask_s, *, block, wcap, k, chunk=8192):
    """The staged model against the plain sweep and JAX's per-pair sweep;
    returns the model's branches."""
    kw = dict(block=block, wcap=wcap, sentinel=SENTINEL)
    got, info = staged_sweep(pts_s, mask_s, k=k, chunk=chunk, **kw)
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
    assert c["kSeqThreads"] == kernel.MAX_BLOCK == kernel._SEQ_THREADS
    assert kernel._QUEUE_CAP == c["kSeqThreads"] * c["kFlagsPerThread"] + \
        c["kSeqThreads"]
    assert c["kResidentBytes"] == kernel._RESIDENT_BYTES
    assert c["kFilterTileBytes"] == kernel._FILTER_TILE_BYTES
    assert c["kSmemLimit"] == kernel.SMEM_LIMIT


@pytest.mark.parametrize("d", range(1, 13))
def test_law_within_the_limit(d):
    """At every d and the largest block, each stage's CTA fits the
    232,448 bytes one CTA may take on sm_90."""
    for block in (1, 2, 256, kernel.MAX_BLOCK):
        law = kernel.sweep_smem_bytes(d, block)
        assert set(law) == {"prefix", "filter", "survivors"}
        assert all(0 < v <= kernel.SMEM_LIMIT for v in law.values()), law
    law = kernel.sweep_smem_bytes(d, kernel.MAX_BLOCK)
    resident = 131_072 // (4 * d)
    assert law["prefix"] == law["survivors"] == (
        4 * d * 512 + 4 * (512 * 16 + 512) + 4 * 32 + 4 * 512
        + 4 * d * resident)
    assert law["filter"] == 4 * d * min(32_768 // (4 * d), 4096)
    # the filter tile is at most the prefix window
    assert kernel.sweep_smem_bytes(d, 256, wcap=10)["filter"] == 40 * d
    assert kernel.sweep_smem_bytes(d, 256, wcap=0)["filter"] == 0


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
