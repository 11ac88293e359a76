"""PyTorch port vs the JAX package: the front end.

Kernel twins against the Pallas kernels in interpret mode (K1
`fast_select_pallas`, K2 `sample_patches_pallas`), ORB extraction against
the JAX kernel path, Hamming matching, RANSAC and the tracker. The CUDA
kernels themselves are compared with their twins by the `cuda`-marked
tests at the end (skipped without a GPU) and by `chip_smoke.py`.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch_parity import jax_setup, ransac_uniforms, torch_setup, world  # noqa: E402

from pose_estimation_tpu.ops import brief_pattern as jbrief  # noqa: E402
from pose_estimation_tpu.ops import matching as jmatch  # noqa: E402
from pose_estimation_tpu.ops import ransac as jransac  # noqa: E402
from pose_estimation_tpu.utils import lie as jlie  # noqa: E402
from pose_estimation_tpu_torch.ops import brief_pattern as tbrief  # noqa: E402
from pose_estimation_tpu_torch.ops import fast as tfast  # noqa: E402
from pose_estimation_tpu_torch.ops import matching as tmatch  # noqa: E402
from pose_estimation_tpu_torch.ops import ransac as transac  # noqa: E402
from pose_estimation_tpu_torch.ops import sample as tsample  # noqa: E402

F32 = np.float32


def _t(a):
    return torch.from_numpy(np.array(a))


def _stack(seed, n, h, w, integer):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0, 255, (n, h, w))
    if integer:
        return np.round(s).astype(F32)
    return ((s + np.roll(s, 1, 1) + np.roll(s, 1, 2)) / 3).astype(F32)


BOUNDS = [(96, 128)] * 2 + [(80, 112)] * 2 + [(64, 96)] * 2


def _select_both(stack, k):
    from pose_estimation_tpu.ops.pallas_fast import fast_select_pallas

    jv, jc, jx, jy = (np.asarray(a) for a in fast_select_pallas(
        jnp.asarray(stack), BOUNDS, 20.0, 7.0, 19, 4, interpret=True))
    g_s, g_i = jax.lax.top_k(jnp.asarray(jv), k)
    g_i = np.asarray(g_i)
    ref = (np.asarray(g_s),) + tuple(np.take_along_axis(a, g_i, 1) for a in (jc, jx, jy))
    tv, tc, tx, ty = tfast.select_plain(_t(stack), BOUNDS, 20.0, 7.0, 19, 4)
    s, (c, x, y) = tfast.plane_topk(tv, (tc, tx, ty), k)
    return ref, (s.numpy(), c.numpy(), x.numpy(), y.numpy()), (jv, tv.numpy())


@pytest.mark.parametrize("integer", [True, False], ids=["integer", "fractional"])
def test_select_plain_matches_pallas_interpret(integer):
    """Twin of K1 + the stable plane top-k against the Pallas kernel + the
    JAX top-k: scores and flat codes exact (integer planes make score ties
    common, so the tie order is exercised), subpixel x/y within 1e-5 px on
    valid slots (same float32 operations; invalid slots carry no
    coordinates in either)."""
    stack = _stack(5 + integer, 6, 96, 128, integer)
    ref, got, (jv, tv) = _select_both(stack, 100)
    np.testing.assert_array_equal(got[0], ref[0])
    valid = ref[0] > -5e8
    assert valid.sum() > 200
    np.testing.assert_array_equal(got[1][valid], ref[1][valid])
    np.testing.assert_allclose(got[2][valid], ref[2][valid], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[3][valid], ref[3][valid], atol=1e-5, rtol=0)
    # per plane, the same candidate set (the kernel's narrow width classes
    # lay their candidates out more compactly, so compare sorted)
    for p in range(6):
        np.testing.assert_array_equal(np.sort(jv[p][jv[p] > -5e8]),
                                      np.sort(tv[p][tv[p] > -5e8]))
    assert tv.shape == (6, 96 // 16 * 128 // 16 * 4)


def test_fast_select_on_cpu_runs_the_twin():
    stack = _t(_stack(2, 6, 96, 128, True))
    before = tfast.fast_select.launches
    got = tfast.fast_select(stack, BOUNDS, 20.0, 7.0)
    ref = tfast.select_plain(stack, BOUNDS, 20.0, 7.0)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert tfast.fast_select.launches == before
    vals, codes, xs, ys = got
    inval = vals < -5e8
    assert (codes[inval] == 0).all() and (xs[inval] == 0).all() and (ys[inval] == 0).all()


def _sample_inputs():
    rng = np.random.default_rng(0)
    n, h, w, k = 4, 96, 128, 64
    stack = _stack(0, n, h, w, False)
    plane = np.repeat(np.arange(n), k // n).astype(np.int32)
    xy = np.stack([rng.uniform(19, w - 20, k), rng.uniform(19, h - 20, k)], -1).astype(F32)
    xy[:4] = [(19, 19), (w - 20, h - 20), (19, h - 20), (w - 20, 19)]   # on the margin
    xy[4] = (30.5, 40.5)                                                # .5 rounding
    return stack, plane, xy


def test_sample_plain_matches_pallas_interpret():
    """Twin of K2 against the Pallas kernel on the same canvases. m10/m01
    within 1e-5 of the largest moment (float32 sums of ~700 terms in
    another order); sample values within 1e-3 intensity on >= 99.9 % of
    entries (a reordered rotation can flip a rounded sample point at .5)."""
    from pose_estimation_tpu.ops.pallas_sample import sample_patches_pallas

    stack, plane, xy = _sample_inputs()
    pool = jbrief.POOL_POINTS.astype(F32)
    jv, j10, j01 = (np.asarray(a) for a in sample_patches_pallas(
        jnp.asarray(stack), jnp.asarray(plane), jnp.asarray(xy), pool,
        t_chunk=8, interpret=True))
    tv, t10, t01 = (a.numpy() for a in tsample.sample_patches_plain(
        _t(stack), _t(plane), _t(xy), _t(pool)))
    scale = max(np.abs(j10).max(), np.abs(j01).max())
    np.testing.assert_allclose(t10, j10, atol=1e-5 * scale, rtol=0)
    np.testing.assert_allclose(t01, j01, atol=1e-5 * scale, rtol=0)
    close = np.abs(tv - jv) <= 1e-3
    assert close.mean() >= 0.999, close.mean()


def test_sample_plain_small_plane_reads_zero_fill():
    """A plane smaller than one 43-px patch: the origin clamps to the
    corner and the patch reads the zero fill past the reflect pad, as the
    Pallas canvas does."""
    from pose_estimation_tpu.ops.pallas_sample import sample_patches_pallas

    stack = _stack(4, 2, 30, 36, False)
    plane = np.array([0, 0, 1, 1], np.int32)
    xy = np.array([[10, 10], [20, 15], [5, 25], [30, 2]], F32)
    pool = jbrief.POOL_POINTS.astype(F32)
    jv, j10, _ = (np.asarray(a) for a in sample_patches_pallas(
        jnp.asarray(stack), jnp.asarray(plane), jnp.asarray(xy), pool,
        t_chunk=2, interpret=True))
    tv, t10, _ = (a.numpy() for a in tsample.sample_patches_plain(
        _t(stack), _t(plane), _t(xy), _t(pool)))
    np.testing.assert_allclose(t10, j10, atol=1e-5 * np.abs(j10).max(), rtol=0)
    assert (np.abs(tv - jv) <= 1e-3).mean() >= 0.999


# 8 levels of a 160x128 pair at scale 1.2 without the detector's 46-px floor:
# the top level's padded content (36 + 4 rows) is shorter than a 43-px patch,
# so its patches read the zero fill
LEVEL_SHAPES = [(128, 160), (107, 133), (89, 111), (74, 93), (62, 77), (51, 64),
                (43, 54), (36, 45)]
LEVEL_BUDGETS = [24, 20, 16, 14, 12, 10, 8, 8]


def _level_inputs(seed, b=2):
    """Content-shaped levels [b, lh, lw], their level-major zero-padded
    plane stack, the per-plane bounds and level-local keypoints [b, kb, 2]
    per level (the margins, a .5 rounding and invalid (0, 0) slots
    included)."""
    rng = np.random.default_rng(seed)
    h, w = LEVEL_SHAPES[0]
    levels, xy_l = [], []
    for (lh, lw), kb in zip(LEVEL_SHAPES, LEVEL_BUDGETS):
        levels.append(_stack(int(rng.integers(1 << 30)), b, lh, lw, False))
        xy = np.stack([rng.uniform(0, lw - 1, (b, kb)), rng.uniform(0, lh - 1, (b, kb))],
                      -1).astype(F32)
        xy[:, 0], xy[:, 1], xy[:, 2] = (0, 0), (lw - 1, lh - 1), (lw / 2 + 0.5, 20.5)
        xy_l.append(xy)
    stack = np.concatenate([np.pad(lv, ((0, 0), (0, h - lv.shape[1]), (0, w - lv.shape[2])))
                            for lv in levels])
    bounds = [shape for shape in LEVEL_SHAPES for _ in range(b)]
    return levels, stack, bounds, xy_l


def test_sample_stack_twin_equals_the_per_level_path():
    """K2's all-levels entry on a CPU tensor (its twin, `sample_stack_plain`)
    against the per-level path it replaces: `sample_patches_plain` on each
    content-shaped level, packed level after level per image. Exactly
    equal, packed layout included, at 8 levels whose top level reads the
    zero fill; the plane of each slot is level * B + image; no launch."""
    levels, stack, bounds, xy_l = _level_inputs(0)
    b = levels[0].shape[0]
    pool = _t(tbrief.POOL_POINTS.astype(F32))
    assert LEVEL_SHAPES[-1][0] + 2 * tsample.PAD < tsample.PS
    ref = []
    for lv, xy in zip(levels, xy_l):
        kb = xy.shape[1]
        vals, m10, m01 = tsample.sample_patches_plain(
            _t(lv), torch.arange(b).repeat_interleave(kb), _t(xy.reshape(b * kb, 2)), pool)
        ref.append(torch.cat([vals, m10[:, None], m01[:, None]], 1).reshape(b, kb, -1))
    ref = torch.cat(ref, dim=1)
    before = tsample.sample_patches.launches
    got = tsample.sample_patches(_t(stack), bounds, _t(np.concatenate(xy_l, 1)),
                                 LEVEL_BUDGETS, pool)
    assert tsample.sample_patches.launches == before
    assert got.shape == (b, sum(LEVEL_BUDGETS), len(pool) + 2)
    assert torch.equal(got, ref)
    expect = np.concatenate([np.full(kb, lvl * b + i) for i in range(b)
                             for lvl, kb in enumerate(LEVEL_BUDGETS)])
    np.testing.assert_array_equal(tsample.slot_planes(b, LEVEL_BUDGETS, "cpu").numpy(), expect)
    # the table the CUDA wrapper hands the kernel: level offsets, then the
    # planes' content heights and widths
    table, _ = tsample._launch_table(tuple(LEVEL_BUDGETS), tuple(bounds))
    n_lv = len(LEVEL_BUDGETS)
    np.testing.assert_array_equal(table[:n_lv + 1], np.cumsum([0] + LEVEL_BUDGETS))
    np.testing.assert_array_equal(table[n_lv + 1:].reshape(2, -1).T, bounds)


def test_brief_pattern_copy_equals_jax():
    np.testing.assert_array_equal(tbrief.POOL_POINTS, jbrief.POOL_POINTS)
    np.testing.assert_array_equal(tbrief.POOL_PAIRS, jbrief.POOL_PAIRS)


@functools.lru_cache(maxsize=1)
def _features():
    """Frames 0 and 1 of the small sim through both extractors."""
    from pose_estimation_tpu.models import vio as jvio
    from pose_estimation_tpu_torch.models import vio as tvio

    _, jconsts, jstatic = jax_setup()
    _, tconsts, tstatic = torch_setup()
    frames = world(2)[0]
    jext = jax.jit(lambda l, r: jvio.extract_rectified(l, r, jconsts, jstatic))
    out = []
    for l, r in frames:
        jf = jax.tree.map(np.asarray, jext(jnp.asarray(l), jnp.asarray(r)))
        tf = tvio.extract_rectified(_t(l), _t(r), tconsts, tstatic)
        out.append((jf, tf))
    return out, (jconsts, jstatic), (tconsts, tstatic)


def test_extract_pair_matches_jax_kernel_path():
    """ORB of a sim stereo pair: the same valid keypoint sets (level 0 is
    bit-exact; the resampled levels come from matrix products whose
    float32 sums may differ in the last bit), rectified coordinates within
    1e-3 px, descriptor bit-flip rate <= 1e-3 on keypoints both keep."""
    feats, _, _ = _features()
    for jf2, tf2 in feats:
        for jf, tf in zip(jf2, tf2):
            jvalid, tvalid = jf.valid, tf.valid.numpy()
            assert jvalid.sum() > 50
            both = jvalid & tvalid
            assert (jvalid != tvalid).sum() <= 0.01 * jvalid.sum()
            np.testing.assert_allclose(tf.xy.numpy()[both], jf.xy[both], atol=1e-3, rtol=0)
            np.testing.assert_array_equal(tf.level.numpy(), jf.level)
            lvl0 = both & (jf.level == 0)
            np.testing.assert_array_equal(tf.score.numpy()[lvl0], jf.score[lvl0])
            flips = (tf.desc.numpy()[both] != jf.desc[both]).mean()
            assert flips <= 1e-3, flips


def test_descriptor_differences_at_protocol_size_are_ties():
    """ORB of an accuracy-protocol frame (320x240, 4 levels) against the
    JAX kernel path. About a fifth of the BRIEF pairs compare two samples
    of the simulator's flat background, equal up to float32 rounding; such
    a tie's bit follows the last bits of the resampled background, which
    the two packages' pyramid products round differently at levels >= 1.
    So bits differ, but only on ties: of the bits whose pair the port
    separates by more than 1e-4 intensity, at most 1e-4 differ."""
    import sim as jsim

    from pose_estimation_tpu.ops import orb as jorb
    from pose_estimation_tpu_torch.ops import orb as torb

    sim = jsim.StereoInertialSim(jsim.sim_config(), n_landmarks=150, seed=0)
    imgs = np.stack(sim.render(0.1)).astype(F32)
    tcfg = torb.OrbConfig(n_features=600, n_levels=4)
    oc = torb.build_orb_constants(240, 320, tcfg, "cpu")
    tf = torb.extract_batch(_t(imgs), tcfg, oc)
    jcfg = jorb.OrbConfig(n_features=600, n_levels=4, sample_backend="pallas_interpret")
    jf = jax.tree.map(np.asarray, jax.jit(lambda x: jorb.extract_batch(x, jcfg))(
        jnp.asarray(imgs)))
    levels = torb.pyramid_levels(_t(imgs), oc)
    n_flip = n_sep = n_sep_flip = 0
    for img in range(2):
        for lvl in range(tcfg.n_levels):
            m = (jf.level[img] == lvl) & jf.valid[img] & tf.valid[img].numpy()
            xy = tf.xy[img].numpy()[m] / F32(tcfg.scale ** lvl)
            vals, _, _ = tsample.sample_patches_plain(
                levels[lvl][img:img + 1].contiguous(), torch.zeros(len(xy), dtype=torch.int32),
                _t(xy), oc.pool_xy)
            sep = np.abs(vals.numpy() @ oc.diff.numpy()) > 1e-4
            flip = tf.desc[img].numpy()[m] != jf.desc[img][m]
            n_flip += flip.sum()
            n_sep += sep.sum()
            n_sep_flip += (flip & sep).sum()
    assert n_flip > 0
    assert n_sep_flip <= 1e-4 * n_sep, (n_sep_flip, n_sep)


def _descs(seed, n, k):
    rng = np.random.default_rng(seed)
    train = np.where(rng.random((k, 256)) < 0.5, 1, -1).astype(np.int8)
    query = train[rng.integers(0, k, n)].copy()
    flip = rng.random(query.shape) < 0.08
    query[flip] *= -1
    train[5] = train[3]            # duplicate rows: argmin ties
    return query, train, rng


def test_matching_exact():
    query, train, rng = _descs(0, 120, 90)
    qm = rng.random(120) < 0.9
    tm = rng.random(90) < 0.9
    np.testing.assert_array_equal(
        tmatch.hamming_table(_t(query), _t(train)).numpy(),
        np.asarray(jmatch.hamming_table(jnp.asarray(query), jnp.asarray(train))))
    ref = jmatch.match(jnp.asarray(query), jnp.asarray(train), jnp.asarray(qm),
                       jnp.asarray(tm), 3.0, 40.0)
    got = tmatch.match(_t(query), _t(train), _t(qm), _t(tm), 3.0, 40.0)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    px_l = rng.uniform(0, 100, (120, 2)).astype(F32)
    px_r = px_l[rng.integers(0, 120, 90)] + rng.normal(0, 1.5, (90, 2)).astype(F32)
    ref = jmatch.stereo_match(jnp.asarray(query), jnp.asarray(train), jnp.asarray(qm),
                              jnp.asarray(tm), jnp.asarray(px_l), jnp.asarray(px_r),
                              3.0, 40.0, 2.0)
    got = tmatch.stereo_match(_t(query), _t(train), _t(qm), _t(tm), _t(px_l), _t(px_r),
                              3.0, 40.0, 2.0)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _two_view(seed, n=200, outliers=0.3):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(2, 9, n)], 1)
    r = np.asarray(jlie.so3_exp(jnp.asarray([0.02, -0.05, 0.01])))
    t = np.array([0.3, 0.05, 0.1])
    x2 = x @ r.T + t
    f = 300.0

    def proj(p):
        return (f * p[:, :2] / p[:, 2:] + [160, 120]).astype(F32)

    p1, p2 = proj(x), proj(x2)
    bad = rng.random(n) < outliers
    p2[bad] += rng.uniform(-40, 40, (bad.sum(), 2)).astype(F32)
    mask = rng.random(n) < 0.9
    return p1, p2, mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ransac_indices_and_inliers_exact(seed):
    """Same uniforms -> the same sampled index tensor as
    jax.random.choice, and the same inlier set."""
    p1, p2, mask = _two_view(seed)
    key = jax.random.PRNGKey(seed)
    ref_idx = np.asarray(jax.random.choice(
        key, p1.shape[0], shape=(64, 8),
        p=jnp.asarray(mask, jnp.float32) / jnp.maximum(jnp.sum(jnp.asarray(mask, jnp.float32)), 1e-9)))
    u = _t(np.asarray(jax.random.uniform(key, (64, 8), dtype=jnp.float32)))
    np.testing.assert_array_equal(transac.sample_indices(_t(mask), u).numpy(), ref_idx)
    ref = jransac.fundamental_ransac(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask), key)
    got = transac.fundamental_ransac(_t(p1), _t(p2), _t(mask), u)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    assert int(got.n_inliers) == int(ref.n_inliers) > 50


def test_tracker_internal_match_and_external_track():
    """Stereo matching on converted frame-1 features, then circular
    tracking against a pool seeded with frame 0's stereo matches: exact
    masks, slots and pixels with JAX's RANSAC uniforms."""
    from pose_estimation_tpu.frontend import tracker as jtr
    from pose_estimation_tpu.models import pool as jpool
    from pose_estimation_tpu.ops import orb as jorb
    from pose_estimation_tpu_torch.frontend import tracker as ttr
    from pose_estimation_tpu_torch.models import pool as tpool
    from pose_estimation_tpu_torch.ops import orb as torb

    feats, (_, jstatic), (_, tstatic) = _features()
    cap = jstatic.cur_capacity
    args = (jstatic.match_ratio, jstatic.min_match_dist)

    def to_t(f):
        return torb.OrbFeatures(*(_t(a) for a in f))

    curs = []
    for i, (jf, _) in enumerate(feats):
        key = jax.random.PRNGKey(i)
        u = ransac_uniforms(key)
        k1, _k2 = jax.random.split(key)
        jl, jr = (jorb.OrbFeatures(*(jnp.asarray(a) for a in f)) for f in jf)
        jcur = jtr.internal_match(jl, jr, k1, cap, *args, jstatic.max_vertical_dist)
        tcur = ttr.internal_match(to_t(jf[0]), to_t(jf[1]), _t(u[0]), cap, *args,
                                  tstatic.max_vertical_dist)
        for name, a, b in zip(jcur._fields, tcur, jcur):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        curs.append((jcur, tcur, key, u))
    assert int(np.asarray(curs[0][0].valid).sum()) > 30

    jcur0 = curs[0][0]
    pos = np.random.default_rng(0).normal(size=(cap, 3)).astype(F32)
    jp = jpool.insert_features(jpool.init_pool(1024, 4), jcur0.px_l, jcur0.desc_l,
                               jcur0.desc_r, jnp.asarray(pos), jcur0.valid)
    tp = tpool.insert_features(tpool.init_pool(1024, 4, "cpu"), *(
        _t(np.asarray(a)) for a in (jcur0.px_l, jcur0.desc_l, jcur0.desc_r, pos, jcur0.valid)))
    for name, a, b in zip(jp._fields, tp, jp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)

    jcur1, tcur1, key1, u1 = curs[1]
    _k1, k2 = jax.random.split(key1)
    jtrk = jtr.external_track(jcur1, jp, k2, *args)
    ttrk = ttr.external_track(tcur1, tp, _t(u1[1]), *args)
    for name, a, b in zip(jtrk._fields, ttrk, jtrk):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert int(ttrk.n_matches) > 10


# ---- on the card: each CUDA kernel against its twin (skipped without a GPU)


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fast_select_kernel_matches_twin_on_gpu(gpu):
    stack = _t(_stack(5, 6, 96, 128, False)).to(gpu)
    before = tfast.fast_select.launches
    got = tfast.fast_select(stack, BOUNDS, 20.0, 7.0)
    ref = tfast.select_plain(stack, BOUNDS, 20.0, 7.0)
    torch.cuda.synchronize()
    assert tfast.fast_select.launches == before + 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_sample_patches_kernel_matches_twin_on_gpu(gpu):
    """K2 over all 8 levels in one launch against its all-levels twin:
    moments within 1e-5 of the largest (float32 sums in another order),
    samples within 1e-3 on >= 99.9 % (a rounded sample point can flip at
    .5 when the rotation rounds apart)."""
    _, stack, bounds, xy_l = _level_inputs(1)
    args = (_t(stack).to(gpu), bounds, _t(np.concatenate(xy_l, 1)).to(gpu), LEVEL_BUDGETS,
            _t(tbrief.POOL_POINTS.astype(F32)).to(gpu))
    before = tsample.sample_patches.launches
    got = tsample.sample_patches(*args)
    ref = tsample.sample_stack_plain(*args)
    torch.cuda.synchronize()
    assert tsample.sample_patches.launches == before + 1
    n_pool = args[4].shape[0]
    scale = ref[..., n_pool:].abs().max()
    assert (got[..., n_pool:] - ref[..., n_pool:]).abs().max() <= 1e-5 * scale
    assert ((got[..., :n_pool] - ref[..., :n_pool]).abs() <= 1e-3).float().mean() >= 0.999


@pytest.mark.cuda
def test_extract_batch_launches_sample_patches_once_on_gpu(gpu):
    """ORB extraction of a stereo pair on the kernel path: one K2 launch for
    all 8 levels of both images."""
    from pose_estimation_tpu_torch.ops import orb as torb

    cfg = torb.OrbConfig(n_features=300)
    oc = torb.build_orb_constants(128, 160, cfg, gpu)
    imgs = _t(_stack(3, 2, 128, 160, False)).to(gpu)
    before = tsample.sample_patches.launches
    feats = torb.extract_batch(imgs, cfg, oc)
    torch.cuda.synchronize()
    assert tsample.sample_patches.launches == before + 1
    assert bool(torch.isfinite(feats.angle).all())

