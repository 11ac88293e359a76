"""Many processes, one mesh: `torch.distributed` over one process per device.

Counterpart of `pose_estimation_tpu/parallel/multihost.py`. The JAX
package joins processes into one `jax.distributed` cluster and lays a
(data, model) device mesh over all of them; here every device has its own
process (rank), the ranks join one process group, and
`parallel.batched.make_mesh` lays the grid over the ranks, each row of
`model` ranks contiguous (on a multi-card host, one row per host keeps the
model axis's all-reduce on the host's links). The data axis sends nothing;
the model axis reduces the pool match's argmin (`parallel/batched.py`).

`dryrun` runs the JAX package's dry run in N local processes: each joins
the group over a localhost TCP rendezvous, warms a simulated sequence up
with single steps, and steps its lanes once through the mesh and once
through the single-process batched step; the lanes must agree. On one
card the ranks share it, over the gloo backend (NCCL refuses two ranks on
one GPU); NCCL is the default where each rank has a card of its own.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from pose_estimation_tpu_torch.parallel import batched
from pose_estimation_tpu_torch.utils.tree import tree_leaves, tree_map

REPO = Path(__file__).resolve().parents[2]
POS_TOL_M = 1e-5


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     backend: str | None = None) -> None:
    """Join the process group at `coordinator` ("host:port") as rank
    `process_id` of `num_processes`. A rank takes the card numbered by its
    rank modulo the host's cards; the backend defaults to NCCL with cards,
    gloo without."""
    import torch.distributed as dist

    if torch.cuda.is_available():
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def make_multihost_mesh(model: int = 1) -> batched.Mesh:
    """The (data, model) mesh over every rank of the joined process group."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("init_distributed first")
    return batched.make_mesh(model=model)


def make_global(mesh: batched.Mesh, value):
    """This rank's lanes of a batch-major array that every rank holds
    whole: the data rank's contiguous block of the leading axis."""
    lanes = value.shape[0] // mesh.data
    return value[mesh.data_index * lanes:(mesh.data_index + 1) * lanes]


def global_batched_state(static, batch: int, mesh: batched.Mesh, template=None,
                         device="cuda"):
    """This rank's part of a batched state of `batch` lanes over the mesh:
    its data rank's `batch // data` lanes, each a copy of the
    single-sequence `template` (the initial state by default)."""
    from pose_estimation_tpu_torch.models import vio as vio_mod

    if batch % mesh.data:
        raise ValueError(f"{batch} lanes over {mesh.data} data ranks")
    one = template if template is not None else vio_mod.init_vio_state(static, device)
    lanes = batch // mesh.data
    return tree_map(lambda a: a.expand((lanes,) + a.shape).clone(), one)


def _child_main(process_id: int, num_processes: int, port: int, model: int,
                device: str, backend: str | None, config: tuple, lanes: int,
                n_landmarks: int, warmup: int) -> None:
    """One rank of the dry run: the simulator's world (the same on every
    rank), a `warmup`-frame single-sequence warm-up from the true start
    state to seed the pool, then one batched step of this rank's lanes
    through the mesh, timed, and again through the single-process batched
    step. Prints one line `DRYRUN {json}` with the lanes' counts and
    positions, the valid pool slots in each model rank's block before the
    step, and the largest difference between the two steps' states."""
    from pose_estimation_tpu_torch import testing
    from pose_estimation_tpu_torch.camera import CameraModel
    from pose_estimation_tpu_torch.models import vio
    from pose_estimation_tpu_torch.ops import fast, sample

    if device == "cpu":
        torch.set_num_threads(1)
    init_distributed(f"localhost:{port}", num_processes, process_id, backend)
    import torch.distributed as dist

    mesh = make_multihost_mesh(model)
    dev = (torch.device("cuda", torch.cuda.current_device()) if device == "cuda"
           else torch.device("cpu"))
    cfg = getattr(testing, config[0])(**config[1])
    consts, static = vio.build_constants(cfg, CameraModel.from_config(cfg), dev)
    frames, gyrs, accs, mask, truth = testing.sim_frames(cfg, warmup + 1,
                                                         n_landmarks=n_landmarks)

    def inputs(i):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in (frames[i][0], frames[i][1], gyrs[i], accs[i], mask))

    st = testing.seeded_state(static, truth, dev)
    gen = torch.Generator().manual_seed(0)
    for i in range(warmup):
        u = tuple(x.to(dev) for x in vio.draw_ransac_uniforms(gen, "cpu"))
        st, _ = vio.ok_step(st, *inputs(i), None, consts, static, ransac_u=u)

    batch = lanes * mesh.data
    u_all = torch.stack([torch.stack(vio.draw_ransac_uniforms(gen, "cpu"))
                         for _ in range(batch)])
    u_b = make_global(mesh, u_all).to(dev)
    state = global_batched_state(static, batch, mesh, template=st)
    args = tuple(a.expand((lanes,) + a.shape).contiguous() for a in inputs(warmup))
    step = batched.make_batched_step(consts, static, mesh)
    for fn in (fast.fast_select, fast.fast_score_nms, sample.sample_patches):
        fn.launches = 0
    dist.barrier()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, m = step(state, *args, u_b)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = {fn.__name__: fn.launches
                for fn in (fast.fast_select, fast.fast_score_nms, sample.sample_patches)}
    ref, rm = batched.make_batched_step(consts, static)(state, *args, u_b)
    diff = max(float((a.double() - b.double()).abs().max()) if a.is_floating_point()
               else float((a != b).any())
               for a, b in zip(tree_leaves(out), tree_leaves(ref)))
    first = mesh.data_index * lanes
    print("DRYRUN " + json.dumps({
        "rank": process_id, "data_index": mesh.data_index, "model_index": mesh.model_index,
        "lanes": list(range(first, first + lanes)), "device": str(dev),
        "backend": dist.get_backend(), "step_ms": step_ms, "launches": launches,
        "state_max_diff": diff,
        "pool_blocks": state.pool.valid.reshape(lanes, model, -1).sum(-1).tolist(),
        **{k: m[k].tolist() for k in ("n_tracked", "n_stereo", "ba_iters", "pool_size",
                                      "is_keyframe", "rec_p")},
        **{f"{k}_plain": rm[k].tolist() for k in ("n_tracked", "n_stereo", "ba_iters",
                                                 "pool_size", "is_keyframe", "rec_p")},
    }), flush=True)
    dist.barrier()
    dist.destroy_process_group()


def dryrun(num_processes: int = 4, model: int = 2, device: str = "cuda",
           backend: str | None = None,
           config: tuple = ("tiny_config", {"camera_frequency": 40}), lanes: int = 2,
           n_landmarks: int = 250, warmup: int = 2, timeout: float = 600.0) -> list[dict]:
    """Run `_child_main` in `num_processes` local processes (a grid of
    num_processes / model data ranks by `model`), `lanes` lanes a data
    rank, on the configuration `config` names: a function of `testing`
    and its keywords. On a card the kernels are built here first, so the ranks
    find the library built. Every rank must finish within `timeout`
    seconds (all are killed otherwise), every lane must track and run BA,
    and the mesh's lanes must equal the single-process step's: the integer
    metrics exactly, the positions within POS_TOL_M. Returns the ranks'
    results, in rank order; raises RuntimeError on any failure."""
    if device == "cuda":
        from pose_estimation_tpu_torch.ops import kernels

        kernels.build()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    code = ("from pose_estimation_tpu_torch.parallel import multihost\n"
            "multihost._child_main({}, {}, {}, {}, {!r}, {!r}, {!r}, {}, {}, {})\n")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code.format(pid, num_processes, port, model, device, backend,
                                           tuple(config), lanes, n_landmarks, warmup)],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(num_processes)]
    deadline = time.monotonic() + timeout
    outs, failed = [], []
    try:
        for pid, p in enumerate(procs):
            try:
                out, err = p.communicate(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                failed.append((pid, "timeout", ""))
                break
            outs.append(out)
            if p.returncode != 0:
                failed.append((pid, p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if failed:
        raise RuntimeError("dryrun failed:\n" + "\n".join(
            f"rank {pid} rc={rc}:\n{err[-3000:]}" for pid, rc, err in failed))
    results = [json.loads(line[len("DRYRUN "):]) for out in outs
               for line in out.splitlines() if line.startswith("DRYRUN ")]
    if len(results) != num_processes:
        raise RuntimeError(f"dryrun: {len(results)} of {num_processes} ranks reported")
    for r in results:
        if min(r["n_tracked"]) <= 0 or min(r["ba_iters"]) <= 0:
            raise RuntimeError(f"dryrun rank {r['rank']}: a lane did not track or run BA: "
                               f"tracked {r['n_tracked']}, BA iterations {r['ba_iters']}")
        for k in ("n_tracked", "n_stereo", "ba_iters", "pool_size", "is_keyframe"):
            if r[k] != r[f"{k}_plain"]:
                raise RuntimeError(f"dryrun rank {r['rank']}: {k} {r[k]} on the mesh, "
                                   f"{r[f'{k}_plain']} in one process")
        err = float(np.abs(np.subtract(r["rec_p"], r["rec_p_plain"])).max())
        if err > POS_TOL_M:
            raise RuntimeError(f"dryrun rank {r['rank']}: positions {err:.3g} m from the "
                               "single-process step's")
    return sorted(results, key=lambda r: r["rank"])
