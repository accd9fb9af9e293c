"""The CUDA dominance kernel's two-grid schedule, modelled in plain torch,
against the plain version and the JAX package's ``'jnp'`` dominance, bit
for bit.

``kernels/dominance/csrc/dominated_mask.cu`` runs one call as (1) the
order-keeping compaction of each batch's valid references, chunk by
chunk, into a dense buffer stored by coordinate with their original
indices (once for references and mask shared by the batch), when R is
longer than one tile, and (2) the walk of every block of candidates:
a head of the first ``kLaneRows`` rows, then tiles of ``tile_rows(d)``
rows, each tested a lane at a time over its first ``kLaneRows`` rows
and then a warp at a time over the rest, the CTA
stopping when all its candidates are decided and ``lower_tri`` ending a
candidate's walk at the first row whose original index is not below its
own.  When R fits one tile, the walk stages the references themselves,
a masked row as NaN.  ``staged_dominance`` below models those steps as
the kernel takes them; it lives here and not in the package, whose plain
version stays the straightforward blocked test.  Dense rows past a
batch's count hold ``-inf`` in the model, which would dominate every
candidate: a walk that read past the count would show.  Tolerance: zero
(the outputs are boolean flags).

The footprint law of the kernel (``kernel.dominance_smem_bytes``) is held
here against the constants of the CUDA source and the card's per-CTA
limit.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.kernels.dominance import dominated_mask as jdominated
from repro_torch.kernels.dominance import kernel
from repro_torch.kernels.dominance import ops

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "dominance" / "csrc" / "dominated_mask.cu")

LANE = kernel._LANE_ROWS
STEP = 32 * kernel._WARP_UNROLL            # rows per warp vote
# candidates per walk CTA, the same for both forms
CTA_ROWS = {t // 32 * h for t, h in kernel._WALK_SHAPE.values()}.pop()
CHUNK = kernel._THREADS * kernel._COMPACT_PER   # reference rows per chunk


def _tile_rows(d, tile_bytes):
    """The kernel's tile law at any tile size: the model runs smaller
    tiles than the kernel's so that small inputs span many of them."""
    return tile_bytes // (4 * d) // 32 * 32


def _pairs(rows, x):
    """(R, C) bool: row j of ``rows`` (R, d) dominates ``x[i]`` (C, d)."""
    le = (rows[:, None, :] <= x[None]).all(-1)
    lt = (rows[:, None, :] < x[None]).any(-1)
    return le & lt


def compact_model(refs, mask, *, chunk=CHUNK, threads=kernel._THREADS):
    """Grid 1 as the kernel runs it: each chunk counts the valid rows of
    the chunks before it; pass e of thread t is row r0 + e * threads + t;
    one ballot per (pass, warp), an exclusive scan of their counts in
    that order, and a row's rank is its scanned count plus the set lanes
    below it.  Returns ``(dense (bc, d, Rs), idx (bc, Rs), count
    (bc,))``; bc is 1 when references and mask are both shared (batch
    stride 0).  Rows past the count hold -inf and index -1."""
    b, r, d = refs.shape
    shared = refs.stride(0) == 0 and mask.stride(0) == 0
    bc = 1 if shared else b
    rs = -(-r // 4) * 4
    dense = torch.full((bc, d, rs), -math.inf)
    idx = torch.full((bc, rs), -1, dtype=torch.int64)
    count = torch.zeros((bc,), dtype=torch.int64)
    passes, warps = chunk // threads, threads // 32
    for bi in range(bc):
        for r0 in range(0, r, chunk):
            before = int(mask[bi, :r0].sum())
            flags = torch.zeros(chunk, dtype=torch.bool)
            end = min(r0 + chunk, r)
            flags[:end - r0] = mask[bi, r0:end]
            ballots = flags.view(passes, warps, 32)        # (pass, warp, lane)
            counts = ballots.sum(-1).flatten()
            offs = (torch.cumsum(counts, 0) - counts).view(passes, warps)
            below = torch.cumsum(ballots, -1) - ballots.long()
            at = before + offs[..., None] + below           # rank in order
            for e, w, ln in torch.nonzero(ballots).tolist():
                row = r0 + e * threads + w * 32 + ln
                pos = int(at[e, w, ln])
                dense[bi, :, pos] = refs[bi, row]
                idx[bi, pos] = row
            if end == r:                  # the last chunk's CTA
                count[bi] = before + int(counts.sum())
    return dense, idx, count


def _walk(rows, ridx, x, i, lo, hi, lower_tri):
    """Each candidate's walk over rows [lo, hi) in order, as the lane form
    takes it: stop at the first dominator, or under lower_tri at the
    first row whose original index is not below the candidate's.
    Returns (dominated, stopped past its index)."""
    dom = _pairs(rows[lo:hi], x)                         # (rows, cands)
    ok = torch.ones_like(dom)
    if lower_tri:
        ok = ridx[lo:hi, None] < i[None, :]
    ok = torch.cumprod(ok.to(torch.int32), 0).bool()     # a prefix
    return (dom & ok).any(0), ~ok.all(0)


def _warp(rows, ridx, y, iy, lo, hi, lower_tri):
    """The warp form for one candidate: STEP rows per vote."""
    for j0 in range(lo, hi, STEP):
        if lower_tri and int(ridx[j0]) >= iy:
            return False
        j1 = min(j0 + STEP, hi)
        ok = (ridx[j0:j1] < iy) if lower_tri else torch.ones(j1 - j0,
                                                              dtype=bool)
        if bool((ok & _pairs(rows[j0:j1], y[None])[:, 0]).any()):
            return True
    return False


def _test_tile(rows, ridx, x, i, todo, t0, t1, lower_tri):
    """Rows [t0, t1) against the undecided candidates, as the kernel's
    test_tile takes them: the lane form over the first LANE rows, then the
    warp form over the rest for each candidate still alive.  Returns the
    candidates it found dominated and the new undecided set."""
    lane_end = min(t1, t0 + LANE)
    d_lane, _ = _walk(rows, ridx, x, i, t0, lane_end, lower_tri)
    d_t = todo & d_lane
    need = todo & ~d_t & (t1 > lane_end)
    if lower_tri and t1 > lane_end:
        need &= ridx[lane_end] < i
    for k in torch.nonzero(need).flatten().tolist():
        d_t[k] = _warp(rows, ridx, x[k], int(i[k]), lane_end, t1, lower_tri)
    todo = todo & ~d_t
    if lower_tri:       # every later row lies past the candidate
        todo &= ~(ridx[t1 - 1] >= i)
    return d_t, todo


def staged_dominance(cands, refs, mask, *, lower_tri=False,
                     tile_bytes=kernel.TILE_BYTES, trace=None):
    """The kernel's schedule on a (B, C, d) batch against (B, R, d)
    references and a (B, R) mask, any batch stride.  Returns the (B, C)
    flag.  ``trace``, when a dict, receives per batch the rows the walk
    ran over (``n``), the largest number of ring tiles a CTA staged
    (``tiles``) and whether grid 1 ran (``compacted``)."""
    b, c, d = cands.shape
    r = refs.shape[1]
    t_rows = _tile_rows(d, tile_bytes)
    compacted = r > t_rows
    if compacted:
        dense, didx, count = compact_model(refs, mask)
        shared = dense.shape[0] == 1 and b > 1
    out = torch.zeros((b, c), dtype=torch.bool)
    if trace is not None:
        trace.update(n=[], tiles=[], compacted=compacted)
    for bi in range(b):
        if compacted:
            bd = 0 if shared else bi
            n = int(count[bd])
            rows, ridx = dense[bd].T, didx[bd]
            # the head (the first LANE rows), then the ring's tiles
            pre = min(n, LANE)
            spans = [(0, pre)] + [(t0, min(t0 + t_rows, n))
                                  for t0 in range(pre, n, t_rows)]
        else:
            n = r
            rows = torch.where(mask[bi, :, None], refs[bi],
                               torch.tensor(math.nan))  # NaN never dominates
            ridx = torch.arange(r)
            spans = [(0, r)]                     # one tile, no ring
        most = 0
        for c0 in range(0, c if n else 0, CTA_ROWS):   # n == 0: all false
            x = cands[bi, c0:c0 + CTA_ROWS]
            i = torch.arange(c0, c0 + x.shape[0])
            dom = torch.zeros(x.shape[0], dtype=torch.bool)
            todo = ~dom
            for s, (t0, t1) in enumerate(spans):
                if s and not bool(todo.any()):   # the CTA stops
                    break
                most = max(most, s)
                d_t, todo = _test_tile(rows, ridx, x, i, todo, t0, t1,
                                       lower_tri)
                dom |= d_t
            out[bi, c0:c0 + x.shape[0]] = dom
        if trace is not None:
            trace["n"].append(n)
            trace["tiles"].append(most)
    return out


def _jax(cands, refs, mask, lower_tri):
    return np.asarray(jdominated(jnp.asarray(cands), jnp.asarray(refs),
                                 jnp.asarray(mask), impl="jnp",
                                 lower_tri=lower_tri))


def _check(cands, refs, mask, *, lower_tri=False, tile_bytes=kernel.TILE_BYTES,
           jax_too=True):
    """The model against the plain version and, batch by batch, JAX's
    'jnp'; returns the model's trace."""
    trace = {}
    got = staged_dominance(cands, refs, mask, lower_tri=lower_tri,
                           tile_bytes=tile_bytes, trace=trace)
    want = ops.dominated_mask_torch(cands, refs, mask, lower_tri=lower_tri)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    if jax_too:
        for bi in range(cands.shape[0]):
            np.testing.assert_array_equal(
                got[bi].numpy(),
                _jax(cands[bi].numpy(), refs[bi].contiguous().numpy(),
                     mask[bi].contiguous().numpy(), lower_tri))
    return trace


def _tie_heavy(rng, shape, levels=4):
    """Quantised coordinates (ties, duplicates), some -0.0."""
    x = (rng.integers(0, levels, shape) / levels).astype(np.float32)
    x[rng.random(shape) < 0.1] = -0.0
    return torch.from_numpy(x)


def _uniform(rng, shape):
    return torch.from_numpy(rng.random(shape).astype(np.float32))


def test_compaction_keeps_order_shared_and_per_batch():
    """Grid 1 writes each batch's valid rows in order with their original
    indices, across chunk boundaries; shared references and mask are
    compacted once."""
    rng = np.random.default_rng(0)
    refs = _uniform(rng, (3, 700, 2))
    mask = torch.from_numpy(rng.random((3, 700)) > 0.6)
    dense, idx, count = compact_model(refs, mask, chunk=128, threads=64)
    assert dense.shape == (3, 2, 700)
    for b in range(3):
        rows = torch.nonzero(mask[b]).flatten()
        n = int(count[b])
        assert n == rows.numel()
        assert torch.equal(idx[b, :n], rows)
        assert torch.equal(dense[b, :, :n].T, refs[b, rows])
        assert bool(torch.isneginf(dense[b, :, n:]).all())
    shared = compact_model(refs[:1].expand(3, -1, -1),
                           mask[:1].expand(3, -1), chunk=128, threads=64)
    assert shared[0].shape[0] == 1 and int(shared[2][0]) == int(mask[0].sum())
    # shared references with per-batch masks: compacted per batch
    per = compact_model(refs[:1].expand(3, -1, -1), mask, chunk=128,
                        threads=64)
    assert per[0].shape[0] == 3 and per[2].tolist() == mask.sum(1).tolist()


@pytest.mark.parametrize("d", range(1, 13))
def test_ties_negative_zero_duplicates_each_d(d):
    """Tie-heavy data with -0.0 and duplicated rows, compacted (R past one
    tile) and direct, with and without lower_tri."""
    rng = np.random.default_rng(d)
    tb = 32 * 4 * d          # one 32-row tile: several tiles at small R
    cands = _tie_heavy(rng, (2, 150, d))
    refs = torch.cat([_tie_heavy(rng, (2, 100, d)), cands[:, :60]], 1)
    mask = torch.from_numpy(rng.random((2, 160)) > 0.3)
    assert _check(cands, refs, mask, tile_bytes=tb)["compacted"]
    assert not _check(cands, refs, mask)["compacted"]
    x = cands
    m = torch.from_numpy(rng.random((2, 150)) > 0.2)
    _check(x, x, m, lower_tri=True, tile_bytes=tb)
    _check(x, x, m, lower_tri=True)


def test_signed_zeros():
    """-0.0 <= +0.0 holds and -0.0 < +0.0 does not, on both paths."""
    z = torch.tensor([[[-0.0, 1.0], [0.0, 1.0], [0.0, 0.5]]])
    m = torch.ones(1, 3, dtype=torch.bool)
    for tb in (kernel.TILE_BYTES, 32 * 4 * 2):
        got = staged_dominance(z, z, m, tile_bytes=tb)
        assert got.tolist() == [[True, True, False]]
        got = staged_dominance(z[:, :2], z[:, :2], m[:, :2], tile_bytes=tb)
        assert not bool(got.any())


def test_masked_tail_is_not_walked():
    """A compacted state buffer (its valid rows first, a long masked tail,
    as the streaming evict sees it): the walk ends at the valid count,
    whatever R is."""
    rng = np.random.default_rng(2)
    d, tb = 3, 32 * 4 * 3                  # 32-row tiles
    refs = _uniform(rng, (1, 2000, d))
    mask = torch.zeros(1, 2000, dtype=torch.bool)
    mask[0, :150] = True
    cands = torch.cat([_uniform(rng, (1, 600, d)),
                       torch.full((1, 400, d), 1.7e38)], 1)   # sentinels
    trace = _check(cands, refs, mask, tile_bytes=tb)
    assert trace["compacted"] and trace["n"] == [150]
    # 150 rows: 32 walked first, then at most ceil(118 / 32) tiles, not
    # the (2000 - 32) / 32 of the whole buffer
    assert trace["tiles"][0] <= 4


def test_noseq_shape_scattered_masks_and_an_empty_batch():
    """Shared references (batch stride 0) with a mask scattered per batch,
    as NoSeq gives them; batch 0 has no valid reference and walks
    nothing, the others only their own rows."""
    rng = np.random.default_rng(3)
    b, c, r, d = 4, 900, 1500, 4
    cands = torch.cat([_uniform(rng, (b, 300, d)),
                       torch.full((b, 600, d), 1.7e38)], 1)
    refs = _uniform(rng, (1, r, d)).expand(b, r, d)
    parts = torch.from_numpy(rng.integers(0, b, r))
    mask = parts[None, :] < torch.arange(b)[:, None]      # ref_parts < own
    mask &= torch.from_numpy(rng.random(r) > 0.5)[None]
    assert not bool(mask[0].any())
    trace = _check(cands, refs, mask, tile_bytes=2048)
    assert trace["compacted"]
    assert trace["n"] == mask.sum(1).tolist() and trace["tiles"][0] == 0
    assert not bool(staged_dominance(cands, refs, mask)[0].any())


def test_all_masked_batch_among_live_ones():
    rng = np.random.default_rng(4)
    cands = _uniform(rng, (3, 200, 3))
    refs = torch.zeros(3, 1500, 3)                     # would dominate all
    refs[1] = _uniform(rng, (1500, 3))
    mask = torch.from_numpy(rng.random((3, 1500)) > 0.5)
    mask[0] = False
    mask[2] = False
    trace = _check(cands, refs, mask)
    assert trace["compacted"] and trace["n"][0] == trace["n"][2] == 0
    out = staged_dominance(cands, refs, mask)
    assert not bool(out[0].any()) and not bool(out[2].any())
    # the same on the direct path, all-masked rows staged as NaN
    trace = _check(cands, refs[:, :300], mask[:, :300])
    assert not trace["compacted"]


@pytest.mark.parametrize("d", [1, 4, 12])
@pytest.mark.parametrize("extra", [0, 1])
def test_r_at_the_small_r_threshold(d, extra):
    """R = tile_rows(d) takes the direct path, one more row grid 1."""
    rng = np.random.default_rng(10 * d + extra)
    r = kernel.tile_rows(d) + extra
    cands = _tie_heavy(rng, (2, 300, d))
    refs = _tie_heavy(rng, (2, r, d))
    mask = torch.from_numpy(rng.random((2, r)) > 0.4)
    trace = _check(cands, refs, mask)
    assert trace["compacted"] == bool(extra)
    assert kernel.compacts(r, d) == bool(extra)


@pytest.mark.parametrize("tile_bytes", [32 * 4 * 2, 64 * 4 * 2])
def test_lower_tri_across_several_tiles(tile_bytes):
    """lower_tri by original index over tiles of 32 and 64 rows: masked
    rows change which dense row holds an index, and the stop is by the
    index, not the dense position."""
    rng = np.random.default_rng(5)
    x = _tie_heavy(rng, (2, 700, 2))
    mask = torch.from_numpy(rng.random((2, 700)) > 0.35)
    trace = _check(x, x, mask, lower_tri=True, tile_bytes=tile_bytes)
    assert trace["compacted"] and max(trace["tiles"]) > 2
    _check(x[:1], x[:1], mask[:1], lower_tri=True, tile_bytes=tile_bytes)


def test_sentinel_candidates_fall_in_the_first_rows():
    """Padding candidates (the sentinel) are dominated by the first valid
    row, so a CTA of them stages no tile."""
    rng = np.random.default_rng(6)
    cands = torch.full((1, 1024, 4), 1.7e38)
    refs = _uniform(rng, (1, 5000, 4))
    mask = torch.from_numpy(rng.random((1, 5000)) > 0.5)
    trace = _check(cands, refs, mask)
    assert trace["tiles"] == [0]
    assert bool(staged_dominance(cands, refs, mask).all())


@settings(max_examples=25, deadline=None, database=None)
@given(st.integers(1, 3), st.integers(1, 600), st.integers(0, 900),
       st.integers(1, 6), st.booleans(), st.integers(0, 3),
       st.sampled_from([1, 2, 8]), st.integers(0, 2 ** 31 - 1))
def test_hypothesis_schedule(b, c, r, d, lower_tri, share, tiles32, seed):
    """Property: the two-grid schedule is bit for bit the plain version
    and JAX's 'jnp', over ties and -0.0, shared references with shared
    or per-batch masks, all-masked batches, tiles of 32 to 256 rows, R on
    either side of one tile, and lower_tri."""
    rng = np.random.default_rng(seed)
    if lower_tri:
        r = c
    cands = _tie_heavy(rng, (b, c, d), levels=3)
    refs = cands if lower_tri else _tie_heavy(rng, (b, r, d), levels=3)
    mask = torch.from_numpy(rng.random((b, r)) > rng.random())
    if share & 1 and not lower_tri:
        refs = refs[:1].expand(b, r, d)
    if share & 2:
        mask = mask[:1].expand(b, r)
    elif b > 1:
        mask[int(rng.integers(0, b))] = False
    _check(cands, refs, mask, lower_tri=lower_tri,
           tile_bytes=tiles32 * 32 * 4 * d)


# -- the footprint law ----------------------------------------------------

def _source_constants():
    src = SOURCE.read_text()
    return {name: int(val) for name, val in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}


def test_law_mirrors_the_source():
    """The wrapper's constants are the CUDA source's."""
    c = _source_constants()
    assert c["kTileBytes"] == kernel.TILE_BYTES
    assert c["kStages"] == kernel._STAGES
    assert c["kThreads"] == kernel._THREADS
    assert kernel._WALK_SHAPE == {
        "direct": (c["kDirectThreads"], c["kDirectHeld"]),
        "ring": (c["kRingThreads"], c["kRingHeld"])}
    for threads, held in kernel._WALK_SHAPE.values():
        assert 32 <= threads <= 1024 and threads % 32 == 0
        assert 1 <= held <= 32 and threads // 32 * held == CTA_ROWS
    assert c["kLaneRows"] == kernel._LANE_ROWS
    assert c["kWarpUnroll"] == kernel._WARP_UNROLL
    assert c["kLaneUnroll"] == kernel._LANE_UNROLL
    assert c["kCompactPer"] == kernel._COMPACT_PER
    assert c["kSmemLimit"] == kernel.SMEM_LIMIT


@pytest.mark.parametrize("d", range(1, 13))
def test_law_within_the_limit(d):
    """At every d each form's CTA fits the 232,448 bytes one CTA may
    take, and a tile holds whole 32-row steps, at least one."""
    t = kernel.TILE_BYTES // (4 * d) // 32 * 32
    assert kernel.tile_rows(d) == _tile_rows(d, kernel.TILE_BYTES) == t
    assert t % 32 == 0 and t >= 32
    law = kernel.dominance_smem_bytes(d)
    assert law == {"ring": 4 * (d + 1) * (32 + 2 * t),
                   "direct": 4 * (d + 1) * t}
    assert all(0 < v <= kernel.SMEM_LIMIT for v in law.values()), law
    assert kernel.dominance_smem_bytes(d, r=33)["direct"] == 4 * (d + 1) * 64
    assert kernel.dominance_smem_bytes(d, r=0)["direct"] == 0
    assert kernel.tile_rows(4) == 1024


def test_scratch_words():
    """NoSeq's shape: B = 8 batches of 65,536 references at d = 4 take
    8 x 5 x 65,536 words of dense rows plus 8 counts (10.5 MB)."""
    assert kernel.scratch_words(8, 65_536, 4, shared=False) == \
        8 * 5 * 65_536 + 8
    assert kernel.scratch_words(8, 1001, 4, shared=True) == 5 * 1004 + 1


def test_check_args_raises_above_the_limit(monkeypatch):
    cands = torch.rand(2, 64, 4)
    refs = torch.rand(2, 2000, 4)
    mask = torch.ones(2, 2000, dtype=torch.bool)
    kernel.check_args(cands, refs, mask)
    monkeypatch.setattr(kernel, "SMEM_LIMIT",
                        kernel.dominance_smem_bytes(4)["ring"] - 1)
    with pytest.raises(ValueError, match="shared memory"):
        kernel.check_args(cands, refs, mask)
    kernel.check_args(cands, refs[:, :100], mask[:, :100])   # direct fits
    monkeypatch.setattr(kernel, "SMEM_LIMIT",
                        kernel.dominance_smem_bytes(4, r=100)["direct"] - 1)
    with pytest.raises(ValueError, match="shared memory"):
        kernel.check_args(cands, refs[:, :100], mask[:, :100])


def test_check_args_takes_more_batches_than_one_grid_y():
    """Grid 1 takes the batches on its y axis in slices of 65,535, so
    more batches than one slice pass, with references past one tile
    (grid 1 runs) or not; grid 2's 1-D grid caps the candidate blocks
    below 2^31."""
    b = 70_000
    kernel.check_args(torch.rand(b, 1, 2), torch.rand(b, 8, 2),
                      torch.ones(b, 8, dtype=torch.bool))
    r = kernel.tile_rows(2) + 1
    refs = torch.rand(1, r, 2).expand(b, r, 2)
    mask = torch.ones(1, r, dtype=torch.bool).expand(b, r)
    assert kernel.compacts(r, 2)
    kernel.check_args(torch.rand(b, 1, 2), refs, mask)
    c = 128 * (2 ** 31 // b + 1)          # too many candidate blocks
    with pytest.raises(ValueError, match="candidate blocks"):
        kernel.check_args(torch.rand(1, 1, 2).expand(b, c, 2)[:, :, :],
                          refs, mask)
