"""The streamed lm head (rows 10 and 11, ``csrc/lm_head.cu``) on the CPU:
its plan, its walk, and numpy emulations of what the kernel computes from
its accumulator registers, against the Pallas kernels in interpret mode
(the kernel itself runs only on the card, in chip_smoke.py):

* ``lm_head_plan``: every (chunk, row) is covered once by the walk of
  (chunk, row group, warpgroup) tiles, the shared memory fits two CTAs an
  SM (one wave of the 251 chunks on an H100), and shapes the kernel does
  not take raise;
* the m64n128 accumulator fragment: every (row, column) of the tile lies
  in one register of one thread, and a row's 128 columns in one quad;
* the register epilogue: per-thread values in the kernel's column order,
  then the two ``shfl_xor`` steps of the quad, carrying (value, column) for
  the earliest argmax, and the raw max, masked max and sum of exponentials
  of the stats, on the Pallas logits; against ``pallas_lm_head`` greedy
  (cmax, carg) and stats (cmax), on "normal" and "ties" inputs with a
  fully masked chunk and a fully masked row;
* the one-launch merge of the stats: the last CTAs to be counted merge the
  rows in shares, one row a warp, lanes over the chunks in a fixed order,
  with the CTAs finishing in shuffled orders; m and L against the Pallas
  kernel at the bars of tests/test_lm_head.py, the same bits whatever the
  order, and every row merged once, launch after launch.

Inputs are made from seeds with numpy.
"""
import faulthandler
import functools
import signal

import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

from mmdx_tpu_torch.ops import lm_head

CHUNK = lm_head.CHUNK
V, D = 40 * CHUNK, 64  # 40 chunks: lanes hold one or two of a row
F32 = np.float32


@pytest.fixture(autouse=True)
def time_guard():
    """An alarm raises in a test still running Python code at 120 s; a
    watchdog ends the process at 180 s if its main thread is blocked in
    native code, where the alarm cannot run."""
    def expire(signum, frame):
        raise TimeoutError("test exceeded its 120 s guard")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(120)
    faulthandler.dump_traceback_later(180, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


# ---------------------------------------------------------------------------
# the plan and the walk
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 4, 16, 20, 64, 65, 100, 128, 129, 200, 256])
def test_walk_covers_every_chunk_row_once(n):
    """The walk's tiles cover each (chunk, row < n) exactly once; a tile's
    rows past n are only TMA's zeros; a row group is 64 rows a warpgroup."""
    v = 5 * CHUNK
    plan = lm_head.lm_head_plan(n, v, D)
    assert plan.warpgroups == (1 if n <= 64 else 2)
    assert plan.row_groups == -(-n // (64 * plan.warpgroups))
    seen = np.zeros((v // CHUNK, n), dtype=int)
    for chunk, g, w, row0, rows in lm_head.lm_head_walk(n, v, plan):
        assert row0 == (g * plan.warpgroups + w) * 64 and 0 <= rows <= 64
        seen[chunk, row0:row0 + rows] += 1
    np.testing.assert_array_equal(seen, 1)


@pytest.mark.parametrize("n", [1, 16, 64, 65, 128, 256, 1024])
def test_plan_fits_two_ctas_per_sm(n):
    """The ring fills its 96 KB budget, two CTAs fit an H100 SM beside the
    runtime's 1 KB each, and the 251 chunks of the T5 vocabulary run in one
    wave on 132 SMs; the mask tile of a row group fits one stage."""
    plan = lm_head.lm_head_plan(n, 32128, 512)
    smem = lm_head.smem_bytes(plan.warpgroups, plan.stages)
    assert plan.stages * lm_head.stage_bytes(plan.warpgroups) <= lm_head.STAGE_BUDGET
    assert plan.stages >= 3 and smem <= 232448
    assert plan.ctas_per_sm == 2
    assert 2 * (smem + lm_head.CTA_RESERVED) <= lm_head.SM_SMEM
    assert plan.waves == 1
    assert 64 * plan.warpgroups * CHUNK <= lm_head.stage_bytes(plan.warpgroups)


@pytest.mark.parametrize("n, v, d", [(0, 512, 64), (4, 500, 64), (4, 512, 48),
                                     (4, 0, 64)])
def test_plan_raises_on_unsupported_shapes(n, v, d):
    with pytest.raises(ValueError, match="lm_head_plan"):
        lm_head.lm_head_plan(n, v, d)


def test_fragment_layout():
    """Thread t, register i of the m64n128k16 f32 fragment (the layout the
    epilogue reads, ``csrc/lm_head.cu:epilogue``) hold each (row, column)
    of the 64 x 128 tile once, and row r's 128 columns lie in the four
    lanes of one quad."""
    rows, cols = fragment()
    owner = np.zeros((64, CHUNK), dtype=int)
    np.add.at(owner, (rows, cols), 1)
    np.testing.assert_array_equal(owner, 1)
    t = np.broadcast_to(np.arange(128)[:, None], rows.shape)
    for r in range(64):
        quads = set((t[rows == r] // 4).tolist())
        assert len(quads) == 1


# ---------------------------------------------------------------------------
# the register epilogue and the merge, emulated
# ---------------------------------------------------------------------------
def fragment():
    """(row, column) of register i of thread t: [128, 64] each."""
    t, i = np.arange(128)[:, None], np.arange(64)[None, :]
    j, h, e = i // 4, (i % 4) // 2, i % 2
    return (t // 32) * 16 + (t % 32) // 4 + 8 * h, 8 * j + 2 * (t % 4) + e


def thread_values(x):
    """[R, 128] -> [R, 4, 32]: lane q of a row's quad holds columns 8j + 2q
    + e, in the order j, then e."""
    r = x.shape[0]
    return x.reshape(r, 16, 4, 2).transpose(0, 2, 1, 3).reshape(r, 4, 32)


def quad(values, combine):
    """The two shfl_xor steps: lane q takes combine(own, lane q ^ o) for o =
    1, then 2. -> lane 0's values; every lane must hold the same."""
    for o in (1, 2):
        partner = [q ^ o for q in range(4)]
        values = combine(values, tuple(v[:, partner] for v in values))
    for v in values:
        assert (v == v[:, :1]).all() or np.isnan(v).all()
    return tuple(v[:, 0] for v in values)


def greedy_tile(x, banned):
    """The greedy epilogue of a [R, 128] tile: the thread's earliest
    maximum of its masked values, then the quad keeps the larger value, or
    on equal values the lower column. -> (cmax [R], carg [R])."""
    v = thread_values(np.where(banned, -np.inf, x).astype(F32))
    loc = v.argmax(-1)  # the first of equal values, -inf included
    best = np.take_along_axis(v, loc[..., None], -1)[..., 0]
    col = 8 * (loc // 2) + 2 * np.arange(4)[None, :] + loc % 2

    def keep(own, other):
        take = (other[0] > own[0]) | ((other[0] == own[0]) & (other[1] < own[1]))
        return tuple(np.where(take, o, s) for s, o in zip(own, other))

    return quad((best, col), keep)


def stats_tile(x, banned):
    """The stats epilogue of a [R, 128] tile -> (raw max, masked max, sum
    of exp(x - raw max) in the thread's column order, then (t0 + t1) + (t2
    + t3)), each [R] f32."""
    v = thread_values(x.astype(F32))
    vm = thread_values(np.where(banned, -np.inf, x).astype(F32))
    rmax, mmax = quad((v.max(-1), vm.max(-1)),
                      lambda own, other: tuple(np.maximum(s, o) for s, o in zip(own, other)))
    se = np.zeros(v.shape[:2], F32)
    for k in range(32):
        se = (se + np.exp((v[..., k] - rmax[:, None]).astype(F32))).astype(F32)
    (se,) = quad((se,), lambda own, other: ((own[0] + other[0]).astype(F32),))
    return rmax, mmax, se


def epilogues(logits, mask, n):
    """Every tile of the kernel's walk through the register epilogues ->
    greedy (cmax, carg) and stats (pmax, psum, cmax), each [n, C]."""
    c = logits.shape[1] // CHUNK
    out = {k: np.full((n, c), np.nan, F32) for k in ("gmax", "carg", "pmax", "psum", "smax")}
    plan = lm_head.lm_head_plan(n, logits.shape[1], D)
    for chunk, _, _, row0, rows in lm_head.lm_head_walk(n, logits.shape[1], plan):
        sl = (slice(row0, row0 + rows), slice(chunk * CHUNK, (chunk + 1) * CHUNK))
        if rows == 0:
            continue
        x, banned = logits[sl], mask[sl]
        out["gmax"][sl[0], chunk], out["carg"][sl[0], chunk] = greedy_tile(x, banned)
        (out["pmax"][sl[0], chunk], out["smax"][sl[0], chunk],
         out["psum"][sl[0], chunk]) = stats_tile(x, banned)
    for k, a in out.items():
        assert not np.isnan(a).any(), f"{k}: the walk left entries uncovered"
    return out


def fma(a, b, c):
    """f32 a * b + c rounded once (nvcc contracts the merge's multiply-add)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c).astype(F32)


def merge_row(pm, ps):
    """``csrc/lm_head.cu:merge_rows`` for one row's partials [C]: lane l of
    a warp takes chunks l, l + 32, ... in order, then an xor butterfly over
    the 32 lanes. -> (m, L)."""
    mx = pm.max()
    lanes = np.zeros(32, F32)
    for lane in range(32):
        for c in range(lane, pm.shape[0], 32):
            lanes[lane] = fma(ps[c], np.exp((pm[c] - mx).astype(F32)), lanes[lane])
    for o in (1, 2, 4, 8, 16):
        lanes = (lanes + lanes[np.arange(32) ^ o]).astype(F32)
    assert (lanes == lanes[0]).all()
    return mx, np.log(lanes[0]).astype(F32)


def merge(pmax, psum, order, warps):
    """The one-launch merge with the CTAs counted in ``order`` (their
    tickets): the last R merge the rows in shares (``merge_rows_of``).
    -> (m, L), every row merged once."""
    n, c = pmax.shape
    m, lse = np.full(n, np.nan, F32), np.full(n, np.nan, F32)
    for ticket, _ in enumerate(order):
        for row in lm_head.merge_rows_of(ticket, c, n, warps):
            assert np.isnan(m[row])
            m[row], lse[row] = merge_row(pmax[row], psum[row])
    assert not np.isnan(m).any()
    return m, lse


def lm_inputs(kind: str, n: int, seed: int):
    """hidden, emb (f32) and a ban mask. "ties": small integers, so every
    logit is exact and equal logits tie exactly (emb rows repeated within
    and across chunks). Row 2's second chunk and the last row are fully
    banned."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        hidden = rng.integers(-2, 3, (n, D)).astype(F32)
        emb = rng.integers(-1, 2, (V, D)).astype(F32)
        emb[300:310] = emb[5]
        emb[131] = emb[129]
    else:
        hidden = rng.standard_normal((n, D)).astype(F32)
        emb = rng.standard_normal((V, D)).astype(F32)
    mask = rng.random((n, V)) < 0.2
    mask[2, CHUNK:2 * CHUNK] = True
    mask[-1] = True
    return hidden, emb, mask


@functools.lru_cache(maxsize=None)
def pallas(kind: str, n: int):
    """The inputs and the Pallas greedy and stats results, interpret mode."""
    from mmdx_tpu.ops.pallas_lm_head import lm_head_greedy, lm_head_stats

    hidden, emb, mask = lm_inputs(kind, n, seed=n)
    with pltpu.force_tpu_interpret_mode():
        greedy = [np.asarray(a) for a in lm_head_greedy(hidden, emb, mask)]
        stats = [np.asarray(a) for a in lm_head_stats(hidden, emb, mask)]
    return mask, greedy, stats


CASES = [(kind, n) for kind in ("normal", "ties") for n in (20, 100, 150)]


@pytest.mark.parametrize("kind, n", CASES)
def test_register_epilogue_matches_pallas(kind, n):
    """On the Pallas kernel's logits, the emulated register epilogue gives
    the Pallas greedy cmax and carg and the Pallas stats cmax exactly; a
    fully banned chunk and row give cmax -inf and carg 0."""
    mask, (g_cmax, g_carg), (logits, _, _, s_cmax) = pallas(kind, n)
    out = epilogues(logits, mask, n)
    np.testing.assert_array_equal(out["gmax"], g_cmax)
    np.testing.assert_array_equal(out["carg"], g_carg)
    np.testing.assert_array_equal(out["smax"], s_cmax)
    assert np.isneginf(out["gmax"][2, 1]) and out["carg"][2, 1] == 0
    assert np.isneginf(out["gmax"][-1]).all() and (out["carg"][-1] == 0).all()
    np.testing.assert_array_equal(out["pmax"], logits.reshape(n, -1, CHUNK).max(-1))


@pytest.mark.parametrize("kind, n", CASES)
def test_one_launch_merge_matches_pallas_in_any_order(kind, n):
    """The merge of the emulated partials, with the CTAs finishing in
    chunk order, in reverse and in three shuffled orders, gives the same
    bits each time, and m and L within tests/test_lm_head.py's bars of the
    Pallas kernel's (m to 1e-6 relative, L to 1e-5 relative + 1e-6); the
    fully banned row's m and L come from its raw logits."""
    mask, _, (logits, ref_m, ref_l, _) = pallas(kind, n)
    out = epilogues(logits, mask, n)
    pmax, psum = out["pmax"], out["psum"]  # [n, C], the kernel's layout
    c = pmax.shape[1]
    warps = 4 * lm_head.lm_head_plan(n, V, D).warpgroups + 1
    rng = np.random.default_rng(n)
    orders = [range(c), range(c - 1, -1, -1)] + [rng.permutation(c) for _ in range(3)]
    results = [merge(pmax, psum, order, warps) for order in orders]
    for m, lse in results[1:]:
        assert m.tobytes() == results[0][0].tobytes()
        assert lse.tobytes() == results[0][1].tobytes()
    m, lse = results[0]
    np.testing.assert_allclose(m, ref_m, rtol=1e-6)
    np.testing.assert_allclose(lse, ref_l, rtol=1e-5, atol=1e-6)
    assert np.isfinite(m[-1]) and np.isfinite(lse[-1])


def test_workspace_words():
    """The stats' workspace: partials [2, N, C], then a 64-bit counter
    (``csrc/lm_head.cu:mmdx_lm_head_stats``)."""
    assert lm_head.workspace_words(128, 32128) == 2 * 128 * 251 + 2


@pytest.mark.parametrize("n, warps", [(1, 5), (16, 5), (64, 5), (128, 9), (256, 9),
                                      (1000, 9)])
def test_mergers_cover_every_row_once(n, warps):
    """Over two launches' tickets (the counter keeps growing), each launch's
    last R CTAs merge every row exactly once, R = max(8, ceil(n / warps))
    of the 251 CTAs, one row a warp where n allows."""
    c = 251
    for launch in range(2):
        rows = [r for ticket in range(launch * c, (launch + 1) * c)
                for r in lm_head.merge_rows_of(ticket, c, n, warps)]
        assert sorted(rows) == list(range(n))
        mergers = sum(1 for ticket in range(launch * c, (launch + 1) * c)
                      if lm_head.merge_rows_of(ticket, c, n, warps))
        assert mergers == min(n, max(8, -(-n // warps)))
