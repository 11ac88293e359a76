"""Kernel K1's launch plan (`fast.select_plan`) against its twin.

K1 launches work only for the 32-row x 128-column blocks that hold a pixel
inside a plane's detection border; a fill block per plane writes the
invalid slots of every other cell. The plan is plain Python, so it is held
here to `fast.select_plain` on the CPU: every slot the twin marks valid
lies in a work block, and every slot outside the work blocks is the
twin's invalid value. The kernel itself is compared with the twin at these
plans by the `cuda`-marked tests (skipped without a GPU) and by
`chip_smoke.py`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pose_estimation_tpu_torch.ops import fast  # noqa: E402
from pose_estimation_tpu_torch.ops import orb  # noqa: E402

F32 = np.float32
BORDER = orb.EDGE
KPC = 4


def _stack(seed, h, w, bounds):
    """A level-major style stack: seeded integer noise on each plane's
    content (many FAST corners, score ties), zeros beyond it."""
    rng = np.random.default_rng(seed)
    out = np.zeros((len(bounds), h, w), F32)
    for p, (lh, lw) in enumerate(bounds):
        out[p, :lh, :lw] = np.round(rng.uniform(0, 255, (lh, lw)))
    return torch.from_numpy(out)


def _pyramid_bounds(h, w, levels, images=2):
    shapes = orb.pyramid_shapes(h, w, orb.OrbConfig(n_levels=levels))
    return [s for s in shapes for _ in range(images)]


def _random_bounds(seed, h, w, n):
    """Seeded content sizes: some fill the canvas, some end mid-block, some
    are too small for any pixel to pass the border."""
    rng = np.random.default_rng(seed)
    bounds = [(h, w), (int(rng.integers(2 * BORDER + 1, h)), int(rng.integers(2 * BORDER + 1, w))),
              (int(rng.integers(10, 2 * BORDER)), w), (h, int(rng.integers(10, 2 * BORDER)))]
    while len(bounds) < n:
        bounds.append((int(rng.integers(10, h + 1)), int(rng.integers(10, w + 1))))
    return bounds


def _work_cells(h, w, plan):
    """[N, n_cell_rows, n_cell_cols] bool: the cells inside work blocks."""
    ncr, ncx = 2 * -(-h // fast.BAND), w // fast.CELL
    cr = np.arange(ncr)[:, None] // 2
    cc = np.arange(ncx)[None, :] // fast.TILE_CELLS
    return np.stack([(cr >= b0) & (cr < b0 + nb) & (cc >= t0) & (cc < t0 + nt)
                     for b0, nb, t0, nt in zip(plan.band0, plan.bands, plan.tile0, plan.tiles)])


def _check_plan_against_twin(stack, bounds):
    n, h, w = stack.shape
    plan = fast.select_plan(h, w, bounds, BORDER)
    vals, codes, xs, ys = (a.numpy() for a in fast.select_plain(stack, bounds, 20.0, 7.0,
                                                                BORDER, KPC))
    ncr, ncx = 2 * -(-h // fast.BAND), w // fast.CELL
    work = np.repeat(_work_cells(h, w, plan).reshape(n, -1), KPC, axis=1)
    valid = vals > fast.NEG / 2
    assert valid.sum() > 0
    # every valid slot is in a work block
    assert work[valid].all()
    # every slot outside the work blocks is the twin's invalid value
    skipped = ~work
    assert (vals[skipped] == np.float32(fast.NEG)).all()
    assert (codes[skipped] == 0).all() and (xs[skipped] == 0).all() and (ys[skipped] == 0).all()
    # the plan is tight: each work block holds a pixel inside the border
    n_tiles = -(-ncx // fast.TILE_CELLS)
    for p, (lh, lw) in enumerate(bounds):
        inner = np.zeros((ncr * fast.CELL, n_tiles * fast.TILE_W), bool)
        inner[BORDER:max(lh - BORDER, 0), BORDER:max(lw - BORDER, 0)] = True
        blocks = inner.reshape(ncr // 2, fast.BAND, n_tiles, fast.TILE_W).any(axis=(1, 3))
        expect = np.zeros_like(blocks)
        b0, nb, t0, nt = plan.band0[p], plan.bands[p], plan.tile0[p], plan.tiles[p]
        expect[b0:b0 + nb, t0:t0 + nt] = True
        np.testing.assert_array_equal(blocks, expect)
    assert plan.first == tuple(np.concatenate([[0], np.cumsum(
        np.multiply(plan.bands, plan.tiles))]).tolist())
    return plan


def test_plan_at_euroc_width():
    """The 8 levels of a 752x480 stereo pair: 566 work blocks of the 1,440
    32-row blocks. The twin runs one plane at a time (the whole stack is a
    chip-sized input)."""
    h, w = 480, 752
    bounds = _pyramid_bounds(h, w, 8)
    plan = fast.select_plan(h, w, bounds, BORDER)
    assert plan.first[-1] == 566
    assert len(bounds) * -(-h // fast.BAND) * -(-(w // fast.CELL) // fast.TILE_CELLS) == 1440
    for p in range(0, len(bounds), 2):
        stack = _stack(p, h, w, bounds[p:p + 1])
        _check_plan_against_twin(stack, bounds[p:p + 1])


def test_plan_at_protocol_size():
    """The accuracy protocol's 320x240, 4-level stereo pair: 102 work
    blocks of 192."""
    bounds = _pyramid_bounds(240, 320, 4)
    plan = _check_plan_against_twin(_stack(1, 240, 320, bounds), bounds)
    assert plan.first[-1] == 102


@pytest.mark.parametrize("seed,h,w", [(0, 200, 272), (1, 150, 400), (2, 97, 160)])
def test_plan_on_random_bounds(seed, h, w):
    """Seeded content sizes on canvases whose height is not a multiple of
    32: planes that end mid-block and planes with no pixel inside the
    border (no work block, every slot invalid)."""
    bounds = _random_bounds(seed, h, w, 6)
    plan = _check_plan_against_twin(_stack(seed + 10, h, w, bounds), bounds)
    assert plan.bands[2] == 0 and plan.tiles[3] == 0


def test_launch_table_layout():
    """The table the wrapper hands the launcher: content heights, widths,
    then the plan's fields, int32, cached per shape and bounds."""
    bounds = tuple(_pyramid_bounds(240, 320, 4))
    table, ptr = fast._launch_table(240, 320, bounds, BORDER)
    n = len(bounds)
    assert table.dtype == np.int32 and table.shape == (7 * n + 1,)
    np.testing.assert_array_equal(table[:2 * n].reshape(2, n).T, bounds)
    plan = fast.select_plan(240, 320, bounds, BORDER)
    np.testing.assert_array_equal(table[2 * n:], np.concatenate(plan))
    assert fast._launch_table(240, 320, bounds, BORDER)[1] == ptr


def test_plane_classes():
    """K1's plan has a row per class of consecutive, equally sized planes:
    a level of a level-major stack of any number of images, or a single
    plane where sizes do not repeat."""
    for images in (1, 2, 16, 64):
        bounds = tuple(_pyramid_bounds(480, 752, 8, images))
        assert fast.plane_classes(bounds) == (tuple(bounds[::images]), images)
    rand = tuple(_random_bounds(0, 200, 272, 6))
    assert fast.plane_classes(rand) == (rand, 1)
    a, b = (100, 128), (80, 112)
    assert fast.plane_classes((a, a, b, b, b, b)) == ((a, b, b), 2)
    assert fast.plane_classes((a, a, a, b, b)) == ((a, a, a, b, b), 1)
    # the classes' plan, per image, is the per-plane plan of one image
    bounds = tuple(_pyramid_bounds(480, 752, 8, 8))
    cls, per = fast.plane_classes(bounds)
    one = fast.select_plan(480, 752, cls, BORDER)
    full = fast.select_plan(480, 752, bounds, BORDER)
    assert per * one.first[-1] == full.first[-1] == 8 * 566 // 2


# ---- on the card: the kernel against its twin at these plans (skipped
# without a GPU)


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,levels", [(480, 752, 8), (240, 320, 4), (200, 272, 0)])
def test_fast_select_kernel_matches_twin_at_the_plan_on_gpu(gpu, h, w, levels):
    """K1 over a whole stack in one launch, every slot written: at EuRoC
    width, at the protocol's size, and on random bounds whose upper planes
    leave whole blocks (and one plane entirely) without work."""
    bounds = _pyramid_bounds(h, w, levels) if levels else _random_bounds(0, h, w, 6)
    stack = _stack(3, h, w, bounds).to(gpu)
    before = fast.fast_select.launches
    got = fast.fast_select(stack, bounds, 20.0, 7.0, BORDER, KPC)
    ref = fast.select_plain(stack, bounds, 20.0, 7.0, BORDER, KPC)
    torch.cuda.synchronize()
    assert fast.fast_select.launches == before + 1
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert float((got[2] - ref[2]).abs().max()) <= 1e-5
    assert float((got[3] - ref[3]).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_kernels_take_a_batched_stack_in_one_launch_on_gpu(gpu):
    """ORB extraction of 8 stereo pairs (16 images, 8 levels: 128 planes,
    beyond the 64 the kernels once took by value): one K1 and one K2
    launch, K1 equal to its twin on that stack (scores and codes exactly,
    subpixel within 1e-5), K2's moments within 1e-5 of the largest."""
    from pose_estimation_tpu_torch.ops import sample

    cfg = orb.OrbConfig(n_features=300)
    oc = orb.build_orb_constants(128, 160, cfg, gpu)
    imgs = _stack(4, 128, 160, [(128, 160)] * 16).to(gpu)
    before = (fast.fast_select.launches, sample.sample_patches.launches)
    feats = orb.extract_batch(imgs, cfg, oc)
    torch.cuda.synchronize()
    assert (fast.fast_select.launches, sample.sample_patches.launches) == (
        before[0] + 1, before[1] + 1)
    assert feats.xy.shape[0] == 16 and bool(torch.isfinite(feats.angle).all())
    stack, bounds = orb.plane_stack(imgs, cfg, oc)
    assert stack.shape[0] == 128
    got = fast.fast_select(stack, bounds, 20.0, 7.0, BORDER, KPC)
    ref = fast.select_plain(stack, bounds, 20.0, 7.0, BORDER, KPC)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert float((got[2] - ref[2]).abs().max()) <= 1e-5
    budgets = orb.level_budgets(cfg)
    kps = orb.detect(stack, bounds, cfg, budgets[0])
    xy = torch.cat([kps.xy[lvl * 16:(lvl + 1) * 16, :kb] for lvl, kb in enumerate(budgets)],
                   dim=1).contiguous()
    args = (stack, bounds, xy, budgets, oc.pool_xy)
    g2, r2 = sample.sample_patches(*args), sample.sample_stack_plain(*args)
    n_pool = oc.pool_xy.shape[0]
    assert (g2[..., n_pool:] - r2[..., n_pool:]).abs().max() <= 1e-5 * r2[..., n_pool:].abs().max()
