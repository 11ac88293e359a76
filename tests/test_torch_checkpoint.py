"""PyTorch port: checkpoints (`checkpoint.py`, `VisualInertialSLAM.
save_checkpoint` / `load_checkpoint`) and the `metrics_jsonl` sink.

- a state's round trip, exact, and its metadata;
- a checkpoint of other capacities is rejected;
- a checkpoint written by the JAX package loads into the port, equal;
- the state machine at 320x240, checkpointed in the middle of a run and
  resumed in a new object, continues exactly as the uninterrupted run
  (the generator's state travels with the checkpoint);
- the sink writes the keys per line that the JAX package's sink writes.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch_parity import jax_map_setup, torch_setup, world  # noqa: E402

from pose_estimation_tpu_torch import checkpoint as ckpt  # noqa: E402
from pose_estimation_tpu_torch import convert, testing  # noqa: E402
from pose_estimation_tpu_torch.models import vio as tvio  # noqa: E402
from pose_estimation_tpu_torch.slam import State, VisualInertialSLAM  # noqa: E402
from pose_estimation_tpu_torch.utils.tree import tree_leaves  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: the suite runs its files in parallel
    processes, and torch's default of a thread per core in each of them
    oversubscribes the machine (the state-machine runs here took ~8 s
    alone and ~600 s in a parallel run of the suite); the small tensors of
    these steps gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_roundtrip(tmp_path):
    """Every leaf back bit for bit, with its dtype, and the metadata."""
    _, _, static = torch_setup()
    state = tvio.init_vio_state(static, "cpu")
    state = state._replace(
        bg=torch.tensor([0.1, 0.2, 0.3]),
        win=state.win._replace(p=state.win.p.index_put((torch.tensor(2),),
                                                        torch.tensor([1.0, 2.0, 3.0]))),
        pool=state.pool._replace(fid=torch.arange(static.pool_capacity, dtype=torch.int32)))
    path = str(tmp_path / "ck.npz")
    ckpt.save_checkpoint(path, state, {"frame": 42, "ts": 123456789})
    loaded, meta = ckpt.load_checkpoint(path, static, "cpu")
    assert meta == {"frame": 42, "ts": 123456789}
    assert type(loaded) is type(state) and type(loaded.win.ics) is type(state.win.ics)
    for a, b in zip(tree_leaves(state), tree_leaves(loaded)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_shape_mismatch_rejected(tmp_path):
    _, _, static = torch_setup()
    path = str(tmp_path / "ck.npz")
    ckpt.save_checkpoint(path, tvio.init_vio_state(static, "cpu"))
    with pytest.raises(ValueError, match="leaf"):
        ckpt.load_checkpoint(path, dataclasses.replace(static, pool_capacity=64), "cpu")


def test_reads_the_jax_packages_checkpoint(tmp_path):
    """The leaves are in the JAX package's order: its checkpoint of a
    seeded state loads into the port equal to the converted state."""
    from sim import seeded_state

    from pose_estimation_tpu import checkpoint as jckpt

    _, _, jstatic = jax_map_setup()
    _, _, tstatic = torch_setup()
    state0 = world(1)[4]
    jstate = seeded_state(jstatic, state0)
    path = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(path, jstate, {"frame": 3})
    loaded, meta = ckpt.load_checkpoint(path, tstatic, "cpu")
    assert meta == {"frame": 3}
    ref = convert.state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    for a, b in zip(tree_leaves(loaded), tree_leaves(ref)):
        assert torch.equal(a, b)


class _Split:
    """Feeds one simulated run to `first`; at the first frame at or after
    `t_split` it checkpoints `first` into `second`, which from then on gets
    every call too."""

    def __init__(self, first, second, t_split, path):
        self.first, self.second, self.t_split, self.path = first, second, t_split, path
        self.resumed = False
        self.counters = None

    def collect_imu_data(self, *args):
        for s in (self.first, self.second) if self.resumed else (self.first,):
            s.collect_imu_data(*args)

    def process(self, img_l, img_r, ts):
        if not self.resumed and ts >= self.t_split * 1e9:
            # recovery counters travel with the checkpoint
            self.counters = (self.first._corrupt_streak, self.first._warm_streak)
            self.first._corrupt_streak, self.first._warm_streak = 1, 2
            self.first.save_checkpoint(self.path)
            self.first._corrupt_streak, self.first._warm_streak = self.counters
            self.second.load_checkpoint(self.path)
            assert (self.second._corrupt_streak, self.second._warm_streak) == (1, 2)
            self.second._corrupt_streak, self.second._warm_streak = self.counters
            self.resumed = True
        out = self.first.process(img_l, img_r, ts)
        if self.resumed:
            assert self.second.process(img_l, img_r, ts) == out
        return out


@functools.lru_cache(maxsize=1)
def _jax_sink_keys():
    """The keys of a line of the JAX package's `metrics_jsonl` sink: "ts",
    then ok_step's metrics without the `rec_` ones (slam.py's sink), read
    off the step's output structure without compiling it."""
    from sim import seeded_state

    from pose_estimation_tpu.models import vio as jvio

    _, consts, static = jax_map_setup()
    frames, gyrs, accs, mask, state0 = world(1)
    out = jax.eval_shape(functools.partial(jvio.ok_step, consts=consts, static=static),
                         seeded_state(static, state0), *frames[0], gyrs[0], accs[0], mask,
                         jax.random.PRNGKey(0))
    return ["ts"] + [k for k in out[1] if not k.startswith("rec_")]


def test_resumed_run_continues_identically(tmp_path):
    """320x240, 4 levels: the state machine reaches OK, is checkpointed
    at 0.8 s into a new object (another seed, so only the checkpoint's
    generator state can make it draw the same RANSAC uniforms), and both
    run to 1.3 s on the same inputs: states, the host bookkeeping and the
    recorded poses after the split all equal. The resumed object's
    `metrics_jsonl` lines carry the JAX package's sink keys, one per OK
    frame."""
    cfg = testing.sim_config(keyframe_rotation=0.1, keyframe_translation=0.15)
    first = VisualInertialSLAM(cfg, seed=5, device="cpu", reinit_on_bias_corruption=False)
    sink = tmp_path / "metrics.jsonl"
    second = VisualInertialSLAM(cfg, seed=77, device="cpu", reinit_on_bias_corruption=False,
                                metrics_jsonl=str(sink))
    split = _Split(first, second, 0.8, str(tmp_path / "ck.npz"))
    world_ = testing.StereoInertialSim(cfg, n_landmarks=150, seed=0)
    world_.run(split, duration=1.3, imu_noise=2.4e-3, seed=10)
    assert split.resumed and first.state == second.state == State.OK
    for a, b in zip(tree_leaves(first.vio), tree_leaves(second.vio)):
        assert torch.equal(a, b)
    assert torch.equal(first._gen.get_state(), second._gen.get_state())
    assert first._frame_count == second._frame_count
    assert first._imu_ts == second._imu_ts
    assert len(first._kf_hist) == len(second._kf_hist)
    for ha, hb in zip(first._kf_hist, second._kf_hist):
        for a, b in zip(tree_leaves(ha), tree_leaves(hb)):
            assert torch.equal(a, b)
    n_after = len(second._records)
    assert n_after >= 4
    np.testing.assert_array_equal(first.trajectory[-n_after:], second.trajectory)
    lines = [json.loads(line) for line in sink.read_text().splitlines()]
    assert len(lines) == n_after
    keys = _jax_sink_keys()
    assert all(list(line)[0] == "ts" and sorted(line) == sorted(keys) for line in lines), \
        (list(lines[0]), keys)
    assert [line["ts"] for line in lines] == [int(t) for t in second.trajectory[:, 0]]
    assert all(len(line["p_pred"]) == 3 and line["n_tracked"] >= 0 for line in lines)
