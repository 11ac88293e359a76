"""Captured CUDA graphs of the OK-state steps: the port's counterpart of
the JAX package's `jax.jit` sites.

The JAX package hands each of its device entry points to the device as
one compiled program: the OK frame (`pose_estimation_tpu/slam.py:171`),
its four stages (`:151-170`), the IMU chunk integration (`:217`) and the
batched step (`parallel/batched.py:68`, `parallel/batched_slam.py:57-63`).
Run eagerly, the port's OK frame is ~15.6k kernel launches, each
dispatched from Python. Here each step is captured once as a CUDA graph
(`torch.cuda.CUDAGraph`) and replayed: the host copies the frame's inputs
into static buffers and replays the graph on the current stream.

- `CapturedStep`: one call of a function on static tensors, captured at
  its first call and replayed at every later one.
- `FrameGraphs`: the OK-state steps of one sequence
  (`slam.VisualInertialSLAM`): the fused frame, the staged frame (its four
  stages), the overflow IMU chunks, and `ok_scan` as replays of the fused
  frame (each frame needs the host between its two graphs, so T frames
  cannot be one graph).
- `BatchedGraphs`: the batched step of `parallel.batched` for one batch
  size (`parallel.batched_slam.BatchedReplay`).

The live state is the runner's: static buffers that each step reads and
that the step's last operations overwrite (`commit`, a `copy_` inside
the capture), so replays chain the state with no host copy. A caller that
replaces the state (a reinit, a recovery, `load_checkpoint`) hands the new
tree to `load_state`, which copies it in. A step's outputs are static too:
the next replay overwrites them, so what the caller keeps past that is
copied out first (`snapshot`, one launch).

`torch.linalg.eigh` reads its result on the host, so the PSD clip of the
marginalization prior (`ba.psd_clip`) is the one operation of the OK frame
that no graph holds: each frame is a graph up to the Schur complement, the
clip run eagerly (one host sync), and a graph after it. All graphs of one
runner share one memory pool and are replayed in the order of their
capture.

The kernels' Python launch counters count a launch when the wrapper
issues it: in a capture that is the recording, which runs nothing. Each
step records, at its capture, the launches its graph holds
(`CapturedStep.launches`, from `kernel_counts`), and each
replay runs them all again: `replayed` and `recorded` sum these over the
process, so a kernel's launches run are its wrapper's count - recorded +
replayed.

On the CPU, which the tests use, the same plumbing runs without capture:
each call runs the function on the static buffers and copies its outputs
into static outputs, so an output kept past the next call is overwritten
there too. On CUDA a capture that fails raises, naming the step and the
line of the port where it failed; nothing runs eagerly in its place.
"""

from __future__ import annotations

import ctypes
import functools
import time
import traceback

import torch

from pose_estimation_tpu_torch.imu import preintegration as pre
from pose_estimation_tpu_torch.models import vio as vio_mod
from pose_estimation_tpu_torch.ops import fast, moments, sample
from pose_estimation_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


def kernel_counts() -> dict:
    """The launch counters of the hand kernels on the OK frame's paths."""
    return {fn.__name__: fn.launches for fn in (fast.fast_select, fast.fast_score_nms,
                                                sample.sample_patches, moments.moment_maps)}


# over the process, the launches that captures recorded and that replays ran
recorded: dict[str, int] = {}
replayed: dict[str, int] = {}


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def commit(buffers, new, out):
    """Write the tree `new` into the equal tree of static tensors
    `buffers` (the last operations of a captured step) and return `out`.
    A tensor of `new` or `out` that shares memory with the buffers, other
    than a leaf written onto itself, is cloned first, so that no copy
    changes what another copy or the caller reads."""
    dst, src = tree_leaves(buffers), tree_leaves(new)
    if len(dst) != len(src) or any(d.shape != s.shape or d.dtype != s.dtype
                                   for d, s in zip(dst, src)):
        raise ValueError("commit: the new state's leaves differ from the buffers'")
    held = {_storage(d) for d in dst}

    def detach(t):
        return t.clone() if _storage(t) in held else t

    src = [s if s is d else detach(s) for d, s in zip(dst, src)]
    out = tree_map(detach, out)
    for d, s in zip(dst, src):
        if s is not d:
            d.copy_(s)
    return out


def snapshot(tree):
    """A copy of the tensors of `tree` in one launch: their bytes
    concatenated into one new buffer (the widest types first, so every
    view stays aligned), then viewed back in their types and shapes. For
    what a caller keeps of a step's static outputs or state past the next
    replay."""
    leaves = tree_leaves(tree)
    order = sorted(range(len(leaves)), key=lambda i: -leaves[i].element_size())
    flat = torch.cat([leaves[i].contiguous().view(-1).view(torch.uint8) for i in order])
    views, at = [None] * len(leaves), 0
    for i in order:
        t = leaves[i]
        n = t.numel() * t.element_size()
        views[i] = flat[at:at + n].view(t.dtype).view(t.shape)
        at += n
    return tree_unflatten(tree, iter(views))


@functools.lru_cache(maxsize=1)
def _libcuda():
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphGetNodes.restype = ctypes.c_int
    return lib


def pool_bytes(pool) -> int:
    """The bytes the caching allocator holds for a graph memory pool."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == tuple(pool))


def graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The node count of a graph captured with `keep_graph=True`."""
    n = ctypes.c_size_t(0)
    err = _libcuda().cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None,
                                     ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {err}")
    return n.value


def _where(exc: BaseException) -> str:
    """The innermost line of the port in the tracebacks of `exc` and the
    exceptions it chains."""
    seen = []
    while exc is not None and exc not in seen:
        seen.append(exc)
        exc = exc.__cause__ or exc.__context__
    for e in reversed(seen):
        frames = [f for f in traceback.extract_tb(e.__traceback__)
                  if "pose_estimation_tpu_torch" in f.filename
                  and not f.filename.endswith("graphs.py")]
        if frames:
            f = frames[-1]
            return f"{f.filename.rsplit('pose_estimation_tpu_torch', 1)[-1]}:{f.lineno} ({f.line})"
    return "an unknown line"


class CapturedStep:
    """`fn(*args)` on static tensors: on a CUDA device captured as one graph
    at the first call and replayed at every call; on the CPU called each
    time. `args` are trees of static tensors that the caller owns and
    writes between calls; the outputs are static as well (`out`). The
    caller warms `fn` up before the first call (`_Graphs._run`)."""

    def __init__(self, name: str, fn, args, device, pool=None):
        self.name, self.fn, self.args = name, fn, args
        self.device = torch.device(device)
        self.pool = pool
        self.graph = None
        self.out = None
        self.replays = 0
        # kernel launches held by the graph, and the capture's costs
        self.launches: dict = {}
        self.stats: dict = {}

    def _capture(self):
        before = kernel_counts()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        mode = torch.cuda.get_sync_debug_mode()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                # an operation that would wait for the device raises at once,
                # naming itself, instead of invalidating the capture
                torch.cuda.set_sync_debug_mode("error")
                try:
                    out = self.fn(*self.args)
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
        except Exception as exc:
            raise RuntimeError(f"CUDA graph capture of {self.name} failed at "
                               f"{_where(exc)}: {exc}") from exc
        t1 = time.perf_counter()
        graph.instantiate()
        t2 = time.perf_counter()
        self.graph, self.out = graph, out
        self.launches = {k: n - before.get(k, 0) for k, n in kernel_counts().items()
                         if n != before.get(k, 0)}
        for k, n in self.launches.items():
            recorded[k] = recorded.get(k, 0) + n
        # the pool is the runner's, shared by its graphs: its size after
        # this capture
        self.stats = {"capture_s": t1 - t0, "instantiate_s": t2 - t1,
                      "nodes": graph_nodes(graph), "pool_bytes": pool_bytes(graph.pool())}

    def __call__(self):
        if self.device.type == "cuda":
            if self.graph is None:
                self._capture()
            self.graph.replay()
            for k, n in self.launches.items():
                replayed[k] = replayed.get(k, 0) + n
        else:
            out = self.fn(*self.args)
            if self.out is None:
                self.out = tree_map(torch.clone, out)
            else:
                tree_map(lambda d, s: d.copy_(s), self.out, out)
        self.replays += 1
        return self.out


class _Eager:
    """The warm-up's executor: a runner's chain of steps run eagerly, on
    clones of its state and inputs."""

    @staticmethod
    def captured(name, fn, args):
        return fn(*args)

    @staticmethod
    def clip(name, schur):
        return vio_mod.psd_clip(schur)


class _Graphs:
    """What the runners share: the static state, the static inputs, the
    captured steps, their memory pool, and the eager clip's buffers."""

    def __init__(self, state, consts, static, device):
        self.consts, self.static = consts, static
        self.device = torch.device(device)
        self.state = tree_map(torch.clone, state)
        self.pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        self.steps: dict[str, CapturedStep] = {}
        self._inputs: dict[str, torch.Tensor] = {}
        self._clips: dict[str, torch.Tensor] = {}
        self._warm_paths: set[str] = set()

    def load_state(self, state) -> None:
        """Copy a state tree (a reinit's, a recovery's, a checkpoint's) into
        the static state; leaves that are the buffers themselves stay."""
        commit(self.state, state, ())

    def _put(self, name: str, value: torch.Tensor) -> torch.Tensor:
        """Copy `value` into the static input `name`; a new shape or type
        makes a new buffer and drops the captured steps (they re-capture)."""
        buf = self._inputs.get(name)
        if buf is None or buf.shape != value.shape or buf.dtype != value.dtype:
            if buf is not None:
                self.steps.clear()
                self._clips.clear()
                self._warm_paths.clear()
            buf = self._inputs[name] = value.to(self.device, copy=True)
        else:
            buf.copy_(value)
        return buf

    def captured(self, name, fn, args):
        """Replay the captured step `name` (made from `fn` and `args` at its
        first call)."""
        step = self.steps.get(name)
        if step is None:
            step = self.steps[name] = CapturedStep(name, fn, args, self.device, self.pool)
        return step()

    def clip(self, name, schur):
        """The eager PSD clip between two graphs, into a static buffer that
        the second graph reads."""
        clipped = vio_mod.psd_clip(schur)
        buf = self._clips.get(name)
        if buf is None:
            buf = self._clips[name] = clipped.clone()
        else:
            buf.copy_(clipped)
        return buf

    def _run(self, path: str, chain, *inputs):
        """Run `chain(executor, state, *inputs)` through the captured steps,
        after warming it up once on a side stream, on clones of the state
        and inputs, so that the warm-up neither advances the live state nor
        leaves anything uninitialised for the capture (the kernel library,
        cuBLAS and cuSOLVER handles, the cached launch tables)."""
        if self.device.type == "cuda" and path not in self._warm_paths:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                chain(_Eager, tree_map(torch.clone, self.state),
                      *tree_map(torch.clone, inputs))
            torch.cuda.current_stream(self.device).wait_stream(side)
            torch.cuda.synchronize(self.device)
            self._warm_paths.add(path)
        return chain(self, self.state, *inputs)

    def stats(self) -> dict:
        """Each captured step's replays, launches, capture and instantiate
        seconds, node count and pool bytes."""
        return {name: {"replays": s.replays, "launches": s.launches, **s.stats}
                for name, s in self.steps.items()}


class FrameGraphs(_Graphs):
    """The OK-state steps of one sequence as captured graphs. Each method
    takes the frame's inputs (device or host tensors), copies them into
    the static inputs and replays; the state advances in `self.state`."""

    def _frame_inputs(self, img_l, img_r, gyr, acc, mask, ransac_u):
        return (self._put("img_l", img_l), self._put("img_r", img_r),
                self._put("gyr", gyr), self._put("acc", acc), self._put("mask", mask),
                (self._put("u_stereo", ransac_u[0]), self._put("u_temporal", ransac_u[1])))

    def _fused(self, ex, state, *inputs):
        c, s = self.consts, self.static
        carry = ex.captured("frame.head", lambda st, *a: vio_mod.ok_head(st, *a, c, s),
                        (state, *inputs))
        clipped = ex.clip("frame", carry.ba.schur)
        return ex.captured("frame.tail",
                       lambda st, k, x: commit(st, *vio_mod.track_tail(k, x, c, s)),
                       (state, carry, clipped))

    def ok_step(self, img_l, img_r, gyr, acc, mask, ransac_u) -> dict:
        """One fused OK frame (`models.vio.ok_step` with the uniforms
        given): the static metrics."""
        return self._run("fused", self._fused,
                         *self._frame_inputs(img_l, img_r, gyr, acc, mask, ransac_u))

    def _staged(self, ex, state, img_l, img_r, gyr, acc, mask, u):
        c, s = self.consts, self.static

        def imu(st, *a):
            new, dt = vio_mod.stage_imu(st, *a, c, s)
            return commit(st, new, (dt, new.win.p[-1]))

        def frontend(st, *a):
            new, cur, tr = vio_mod.stage_frontend(st, *a, c, s)
            return commit(st, new, (cur, tr))

        def ba_tail(st, carry, clipped):
            new, cost, iters = vio_mod.stage_ba_finish(carry, clipped, s)
            return commit(st, new, (cost, iters))

        def pool(st, cur, tr, cost, iters, dt, p_pred):
            new = vio_mod.stage_pool(st, cur, tr, tr.n_matches, c, s)
            return commit(st, new, vio_mod.frame_outputs(new, cur, tr, cost, iters, dt,
                                                         p_pred))

        dt, p_pred = ex.captured("imu", imu, (state, gyr, acc, mask))
        cur, tr = ex.captured("frontend", frontend, (state, img_l, img_r, u))
        carry = ex.captured("ba.head", lambda st, n: vio_mod.stage_ba_solve(st, n, c, s),
                        (state, tr.n_matches))
        cost, iters = ex.captured("ba.tail", ba_tail, (state, carry, ex.clip("ba", carry.schur)))
        return ex.captured("pool", pool, (state, cur, tr, cost, iters, dt, p_pred))

    def staged_step(self, img_l, img_r, gyr, acc, mask, ransac_u) -> dict:
        """One OK frame as the four stages (`stage_imu`, `stage_frontend`,
        `stage_ba` in two graphs around the clip, `stage_pool`), each its
        own graph: the static metrics (`models.vio.frame_outputs`)."""
        return self._run("staged", self._staged,
                         *self._frame_inputs(img_l, img_r, gyr, acc, mask, ransac_u))

    def _integrate(self, ex, state, gyr, acc, mask):
        imu = self.consts.imu

        def fn(st, g, a, m):
            preint = pre.integrate_chunk(st.preint, g, a, m, st.bg, st.ba, imu)
            return commit(st, st._replace(preint=preint), ())

        return ex.captured("integrate", fn, (state, gyr, acc, mask))

    def integrate(self, gyr, acc, mask) -> None:
        """Integrate an IMU chunk into the state's running preintegration
        (`imu.preintegration.integrate_chunk`)."""
        self._run("integrate", self._integrate, self._put("gyr", gyr),
                  self._put("acc", acc), self._put("mask", mask))

    def ok_scan(self, imgs_l, imgs_r, gyrs, accs, masks, generator) -> dict:
        """`models.vio.ok_scan` as T replays of the fused frame, the
        uniforms drawn from `generator` in its order: the stacked outputs
        (the newest R, p, v, n_tracked, is_keyframe, need_reinit)."""
        outs = []
        for t in range(imgs_l.shape[0]):
            u = vio_mod.draw_ransac_uniforms(generator, self.device)
            m = self.ok_step(imgs_l[t], imgs_r[t], gyrs[t], accs[t], masks[t], u)
            outs.append(snapshot({"R": m["rec_R"], "p": m["rec_p"], "v": m["rec_v"],
                                  "n_tracked": m["n_tracked"],
                                  "is_keyframe": m["is_keyframe"],
                                  "need_reinit": m["need_reinit"]}))
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


class BatchedGraphs(_Graphs):
    """The batched step of `parallel.batched` (one extraction for the 2B
    images, `vmap` over the frame step) for the batch size of its state,
    as two captured graphs around the clip of the B Schur complements."""

    def __init__(self, state_b, consts, static, device):
        from pose_estimation_tpu_torch.parallel import batched

        super().__init__(state_b, consts, static, device)
        self._head, self._tail = batched.make_batched_parts(consts, static)

    def _batched(self, ex, state, *inputs):
        carry = ex.captured("batch.head", self._head, (state, *inputs))
        clipped = ex.clip("batch", carry.ba.schur)
        return ex.captured("batch.tail", lambda st, k, x: commit(st, *self._tail(k, x)),
                       (state, carry, clipped))

    def step(self, imgs_l, imgs_r, gyr, acc, mask, u_b) -> dict:
        """One batched frame (`parallel.batched.make_batched_step`'s step):
        the static metrics [B, ...]."""
        return self._run("batched", self._batched, self._put("imgs_l", imgs_l),
                         self._put("imgs_r", imgs_r), self._put("gyr", gyr),
                         self._put("acc", acc), self._put("mask", mask),
                         self._put("u", u_b))
