"""The port's two deviations in the SfM bootstrap's PnP from the JAX package
(`ops/pnp.py`), each on a problem built so that the reference's rule and
the port's part ways; the parity tests (`tests/test_torch_init.py`,
`tests/test_torch_p3p.py`) use well-conditioned problems where both rules
take the same hypothesis.

- The DLT's sign: the null vector of the DLT system is P up to its sign,
  and for P = -|s| [R | t] the proper rotation of P[:, :3] is R with a
  half turn. The port takes the sign with det(P[:, :3]) > 0, as OpenCV's
  DLT does; the JAX package keeps what its eigensolver returns. A sample
  whose translation has its largest component negative makes the
  canonical null vector (`small_linalg.eigh`'s signs) come out negative.
- The RANSAC winner: the least truncated squared error (MSAC) against the
  reference's inlier count. Built like the SfM frame where the rules
  disagreed on the card (PERF.md, PR 10 finding 6): landmarks 6-40 m away
  leave translation weakly observed, and two poses 1.6 cm and 6.5 cm from
  the truth keep every landmark within the 8-px gate; one correspondence
  sits just inside the gate for the farther pose and just outside it for
  the nearer one, so the farther pose has one inlier more.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pose_estimation_tpu_torch.ops import pnp as tpnp  # noqa: E402
from pose_estimation_tpu_torch.ops import small_linalg  # noqa: E402
from pose_estimation_tpu_torch.utils import lie  # noqa: E402

FOCAL = 458.0          # px, EuRoC's cam0
GATE_PX = 8.0          # the SfM bootstrap's RANSAC gate


def _pose(rng, t):
    r = lie.so3_exp(torch.from_numpy(rng.normal(size=3) * 0.05)).numpy()
    return r, np.asarray(t, dtype=np.float64)


def _project(r, t, x):
    xc = x @ r.T + t
    return xc[:, :2] / xc[:, 2:3]


def _angle(ra, rb):
    return float(np.degrees(np.arccos(np.clip((np.trace(ra.T @ rb) - 1) / 2, -1, 1))))


def test_dlt_negative_null_vector_gives_the_proper_pose():
    rng = np.random.default_rng(3)
    r, t = _pose(rng, [-8.0, 0.4, 5.0])      # |t_x| the largest entry of [R | t]
    x = np.stack([rng.uniform(6, 10, 6), rng.uniform(-2, 2, 6), rng.uniform(-1, 1, 6)], -1)
    img = _project(r, t, x)
    assert np.all((x @ r.T + t)[:, 2] > 1.0)
    obj_t, img_t = torch.from_numpy(x)[None], torch.from_numpy(img)[None]
    # the canonical null vector of this sample is -|s| [R | t]
    xh = np.concatenate([x, np.ones((6, 1))], -1)
    zero = np.zeros_like(xh)
    a = np.concatenate([np.concatenate([xh, zero, -img[:, :1] * xh], -1),
                        np.concatenate([zero, xh, -img[:, 1:] * xh], -1)])
    _, vecs = small_linalg.eigh(torch.from_numpy(a.T @ a)[None])
    p = vecs[0, :, 0].numpy().reshape(3, 4)
    assert np.linalg.det(p[:, :3]) < 0
    # kept as it came, its proper rotation is R with a half turn
    kept, _, _ = tpnp._proper_rotation(torch.from_numpy(p[None, :, :3]))
    assert _angle(kept[0].numpy(), r) > 179.0
    got_r, got_t = tpnp._dlt_pose(obj_t, img_t)
    assert _angle(got_r[0].numpy(), r) < 1e-4
    np.testing.assert_allclose(got_t[0].numpy(), t, atol=1e-6)


def _two_optima(seed):
    """(obj [N, 3], normalized image points [N, 2], the truth, the nearer
    and the farther pose) of a scene where the farther pose keeps one
    inlier more within the gate."""
    rng = np.random.default_rng(seed)
    r0, t0 = _pose(rng, [0.1, -0.05, 0.3])
    n = 40
    depth = rng.uniform(6.0, 40.0, n)
    uv = rng.uniform(-0.6, 0.6, (n, 2))
    xc = np.concatenate([uv * depth[:, None], depth[:, None]], -1)
    x = (xc - t0) @ r0                                   # camera to object frame
    img = _project(r0, t0, x) + rng.normal(scale=0.7 / FOCAL, size=(n, 2))
    d_near = np.array([0.012, -0.008, 0.007])            # |d| 0.0160 m
    d_far = np.array([0.030, 0.045, -0.035])             # |d| 0.0645 m
    near, far = (r0, t0 + d_near), (r0, t0 + d_far)
    # one more correspondence, 7.9 px from the farther pose's projection,
    # on the side away from the nearer one's
    xb = x[0] * 0.5 + x[1] * 0.5
    pf, pn = _project(*far, xb[None])[0], _project(*near, xb[None])[0]
    away = (pf - pn) / np.linalg.norm(pf - pn)
    obs = pf + away * 7.9 / FOCAL
    return (np.concatenate([x, xb[None]]), np.concatenate([img, obs[None]]), (r0, t0),
            near, far)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_msac_takes_the_pose_nearer_the_truth(seed):
    x, img, (_, t0), near, far = _two_optima(seed)
    thr_n2 = (GATE_PX / FOCAL) ** 2
    r_h = torch.from_numpy(np.stack([near[0], far[0]]))
    t_h = torch.from_numpy(np.stack([near[1], far[1]]))
    obj, img_n = torch.from_numpy(x), torch.from_numpy(img)
    err2 = tpnp._reproj_err2(r_h, t_h, obj, img_n).numpy()
    counts = (err2 < thr_n2).sum(1)
    # the reference's rule: the count takes the farther pose, by one inlier
    assert counts[1] == counts[0] + 1 == len(x)
    best, inliers = tpnp.msac_winner(r_h, t_h, obj, img_n, torch.ones(len(x), dtype=torch.bool),
                                     thr_n2)
    assert int(best[0]) == 0
    assert int(inliers.sum()) == counts[0]
    assert np.linalg.norm(near[1] - t0) < 0.02 < 0.06 < np.linalg.norm(far[1] - t0)
