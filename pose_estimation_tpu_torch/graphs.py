"""Captured CUDA graphs of the port's device calls: its counterpart of the
JAX package's `jax.jit` sites.

The JAX package hands each of its device entry points to the device as
one compiled program: the OK frame (`pose_estimation_tpu/slam.py:171`),
its four stages (`:151-170`), the IMU chunk integration (`:217`), the
batched step (`parallel/batched.py:68`, `parallel/batched_slam.py:57-63`)
and the state machine's other calls: the left image's extraction
(`_seed_ref`), the SfM frame (`_sfm_step`), the constraint of an SfM frame
(`_finalize`), the initializer (`_full_init_jit`), the first OK frame
(`_bootstrap`), the gravity refinement (`_refine_jit`) and the warm
recovery (`_recover_jit`) (`slam.py:176-222`). Run eagerly, the port's OK
frame is ~15.6k kernel launches, each dispatched from Python. Here each
call is captured once as a CUDA graph (`torch.cuda.CUDAGraph`) and
replayed: the host copies the call's inputs into static buffers and
replays the graph on the current stream.

- `CapturedStep`: one call of a function on static tensors, captured at
  its first call and replayed at every later one.
- `FrameGraphs`: the OK-state steps of one sequence
  (`slam.VisualInertialSLAM`): the fused frame (one graph), the staged
  frame (four, one a stage), the overflow IMU chunks, and `ok_scan` (T
  frames in one graph).
- `BatchedGraphs`: the batched step of `parallel.batched` for one batch
  size, one graph (`parallel.batched_slam.BatchedReplay`).
- `SolveGraphs`: the state machine's other calls, one graph per call and
  shape of its inputs, as JAX retraces per shape, captured at the second
  call (the first runs eagerly).

The live state of the OK steps is the runner's: static buffers that each
step reads and that the step's last operations overwrite (`commit`, a
`copy_` inside the capture), so replays chain the state with no host
copy. A caller that replaces the state (a reinit, a recovery,
`load_checkpoint`) hands the new tree to `load_state`, which copies it in.
A step's outputs are static too: the next replay overwrites them, so what
the caller keeps past that is copied out first (`snapshot`, one launch).

No operation of these calls reads the device on the host: the PSD clip of
the marginalization prior and the PnP solvers' eigendecompositions and
SVDs are kernel K6 (`ops/small_linalg.py`), which `torch.linalg.eigh` and
`svd` would check on the host. So an OK frame is one graph.

Memory. The graphs of a `FrameGraphs` (or `BatchedGraphs`) share one
memory pool: they are replayed in the order of their capture, each
frame's or stage's graphs in turn, so a later graph's memory may reuse
what an earlier one freed. `SolveGraphs` break that order: they run
between the OK frames after a relocalization or a cold reinit, and among
themselves `sfm_step` replays again after `refine` was captured. So each
of its graphs has a memory pool of its own, apart from the frame graphs'
and from each other's: a replay overwrites nothing but its own graph's
memory. Only a call made twice has a graph and a pool.

The kernels' Python launch counters count a launch when the wrapper
issues it: in a capture that is the recording, which runs nothing. Each
step records, at its capture, the launches its graph holds
(`CapturedStep.launches`, from `kernel_counts`), and each
replay runs them all again: `replayed` and `recorded` sum these over the
process, so a kernel's launches run are its wrapper's count - recorded +
replayed.

The LM solves' iterations past convergence (`backend/lm.py`,
`backend/full_ba.py`) do not run on the device: in a capture each solve's
loop is one conditional WHILE node (`iterate`, `csrc/graph_cond.cu`), the
counterpart of the JAX package's `lax.while_loop`, its body one iteration.
Nor do the frame step's branches that a frame does not take (motion-only
BA without circular matches, keyframe full BA, the marginalization and
the pool update off their frames, `models/vio.py`; the window's
re-predict on a keyframe, `models/window.py`): each is one conditional IF
node (`cond`), the counterpart of the JAX package's `lax.cond`, and an IF
body may hold a solve's WHILE node. What the nodes leave out are the
fixed loop's frozen iterations and the branches that the select drops, so
a replay equals the eager run bit for bit; the eager path
(`graphed=False`) and the CPU keep the fixed loop and the select as the
yardstick. A step's `stats` count the nodes of its top-level graph and,
apart, those inside its WHILE and its IF bodies.

On the CPU, which the tests use, the same plumbing runs without capture:
each call runs the function on the static buffers and copies its outputs
into static outputs, so an output kept past the next call is overwritten
there too. On CUDA a capture that fails raises, naming the step and the
line of the port where it failed; nothing runs eagerly in its place.
Python's cyclic garbage collector is held off while a step captures: a
dead runner in a reference cycle that it freed there would destroy its
graphs while the stream captures, which CUDA refuses and which breaks the
capture.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import gc
import time
import traceback

import torch

from pose_estimation_tpu_torch.imu import preintegration as pre
from pose_estimation_tpu_torch.models import vio as vio_mod
from pose_estimation_tpu_torch.ops import fast, kernels, moments, sample, small_linalg
from pose_estimation_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


def kernel_counts() -> dict:
    """The launch counters of the hand kernels on the captured paths."""
    return {fn.__name__: fn.launches for fn in (fast.fast_select, fast.fast_score_nms,
                                                sample.sample_patches, moments.moment_maps,
                                                small_linalg.eigh, small_linalg.svd)}


# over the process, the launches that captures recorded and that replays ran
recorded: dict[str, int] = {}
replayed: dict[str, int] = {}
# the step whose graph the current capture records (`CapturedStep._capture`)
_capturing: "CapturedStep | None" = None
# the host form of `iterate`, for the CPU tests (`host_conditionals`)
_host_conditionals = False
# where a list, every LM solve that runs appends (name, its iteration
# count as a device scalar, its cap): eagerly at the solve
# (`log_iterations`), in a graph at each replay (`CapturedStep`); a
# measurement hook, read with `read_iterations`
iteration_log: list | None = None


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


def log_iterations(name: str, iterations: torch.Tensor, cap: int) -> None:
    """Keep an LM solve's iteration count (a device scalar, not read here):
    in a capture with the capturing step (`CapturedStep.iterations`, the
    static buffer each replay writes), else in `iteration_log` where it is
    a list. Under `torch.func.vmap` nothing is kept."""
    if torch._C._functorch.peek_interpreter_stack() is not None:
        return
    if _capturing is not None:
        _capturing.iterations.append((name, iterations, cap))
    elif iteration_log is not None:
        iteration_log.append((name, iterations, cap))


def read_iterations(entries) -> list:
    """[(name, iterations, cap)] of `iteration_log` entries, read in one
    transfer."""
    if not entries:
        return []
    counts = torch.stack([t.to("cpu") for _, t, _ in entries]).tolist()
    return [(name, n, cap) for (name, _, cap), n in zip(entries, counts)]


@contextlib.contextmanager
def host_conditionals():
    """For the CPU tests: inside the block `iterate` and `cond` run their
    conditional forms on the host, on the buffers that the nodes' bodies
    write: `iterate` reads the loop's test on the host and stops where it is
    false, `cond` reads its predicate and runs its branch or not."""
    global _host_conditionals
    before, _host_conditionals = _host_conditionals, True
    try:
        yield
    finally:
        _host_conditionals = before


def _selecting(step) -> bool:
    """Whether a conditional runs as the fixed loop or the select: outside a
    capture and `host_conditionals`, and under `torch.func.vmap`."""
    return (torch._C._functorch.peek_interpreter_stack() is not None
            or (step is None and not _host_conditionals))


def iterate(body, carry, iterations: int, live):
    """`carry = body(carry)`, `iterations` times: an LM solve's loop, whose
    body leaves the carry unchanged once `live(carry)` (a bool scalar
    tensor) is false, so that an iteration past convergence is a no-op.

    In a capture of a `CapturedStep` the loop is one conditional WHILE node
    (`csrc/graph_cond.cu`) whose body, one iteration, is captured once:
    the device runs it while the solve is live and under its cap, and then
    stops, as the JAX package's `lax.while_loop` does. The carry, the count
    and the loop's test live in buffers allocated before the node, which
    the body overwrites in place (`commit`); the body's own tensors come
    from a memory pool of the step's for its depth of nesting
    (`CapturedStep.body_pools`) on a stream of their own (`_body_stream`).
    The iterations not run are exactly the fixed loop's frozen ones, so the
    result is the fixed loop's bit for bit. Outside a capture, and under
    `torch.func.vmap` (whose while_loop JAX runs as a select on every
    lane), the fixed loop runs; inside `host_conditionals` the host tests
    the flag and stops."""
    step = _capturing
    if iterations <= 0 or _selecting(step):
        for _ in range(iterations):
            carry = body(carry)
        return carry
    carry = tree_map(torch.clone, carry)
    flag = live(carry)
    count = torch.zeros((), dtype=torch.int32, device=flag.device)

    def run():
        commit(carry, body(carry), ())
        count.add_(1)
        torch.logical_and(live(carry), count < iterations, out=flag)

    if step is None:
        while bool(flag):
            run()
    else:
        _conditional(step, "while", flag, run)
    return carry


def cond(pred, branch, otherwise, solves=()):
    """`branch()` where the bool scalar tensor `pred` holds, else
    `otherwise`: the JAX package's `lax.cond` for a branch whose other side
    returns the carry as it is, or constants. `branch()` returns a tree of
    tensors equal to `otherwise` in structure, shapes and types; a leaf it
    returns unchanged (the same tensor object as `otherwise`'s) is not
    written. `solves` are the (name, cap) of the LM solves the branch runs,
    in the order they log (`log_iterations`): a solve of a branch not
    taken logs 0 iterations, in every form, as JAX's `skip_ba` does.

    In a capture of a `CapturedStep` the branch is one conditional IF node
    (`csrc/graph_cond.cu`) whose body is the branch, captured once: the
    device runs it only where `pred` holds, as JAX runs one side of the
    cond. The untaken side's values are copied into buffers before the
    node (`snapshot`, one launch) with the solves' iteration counts zeroed,
    and the body overwrites them with the branch's results. A body may hold
    an `iterate` (a WHILE node nested in the IF node), but no hand kernel.
    Eagerly and under `torch.func.vmap` (JAX's vmapped cond is a select)
    the branch is computed and selected (`models.vio.select`), its solves'
    counts made 0 where `pred` is false: the bit-equal yardstick. Inside
    `host_conditionals` the host reads `pred` and runs the branch on the
    buffers, or returns `otherwise` as it is."""
    step = _capturing
    if _selecting(step):
        log = (iteration_log if step is None
               and torch._C._functorch.peek_interpreter_stack() is None else None)
        mark = len(log) if log is not None else 0
        out = branch()
        if log is not None:
            _check_solves(log[mark:], solves)
            log[mark:] = [(name, torch.where(pred, it, 0), cap) for name, it, cap in log[mark:]]
        return vio_mod.select(pred, out, otherwise)
    if pred.dtype != torch.bool or pred.dim() != 0:
        raise ValueError("cond: the predicate is a bool scalar tensor")
    counts = torch.zeros(len(solves), dtype=torch.int32, device=pred.device)
    log = step.iterations if step is not None else iteration_log
    if step is None and not bool(pred):
        if log is not None:
            log.extend((name, counts[k], cap) for k, (name, cap) in enumerate(solves))
        return otherwise
    buffers = snapshot(otherwise)
    changed = []

    def run():
        mark = len(log) if log is not None else 0
        new = branch()
        if log is not None:
            _check_solves(log[mark:], solves)
            for k, (_, it, _) in enumerate(log[mark:]):
                counts[k].copy_(it)
            del log[mark:]
        dst, src, old = tree_leaves(buffers), tree_leaves(new), tree_leaves(otherwise)
        if len(src) != len(old) or any(s.shape != o.shape or s.dtype != o.dtype
                                       for s, o in zip(src, old)):
            raise ValueError("cond: the branch's leaves differ from the untaken side's")
        changed[:] = [s is not o for s, o in zip(src, old)]
        for d, s, c in zip(dst, src, changed):
            if c:
                d.copy_(s)

    if step is None:
        run()
    else:
        _conditional(step, "if", pred, run)
    if log is not None:
        log.extend((name, counts[k], cap) for k, (name, cap) in enumerate(solves))
    # the leaves the branch left alone are the untaken side's own tensors
    leaves = [d if c else o for d, o, c in zip(tree_leaves(buffers), tree_leaves(otherwise),
                                                changed)]
    return tree_unflatten(otherwise, iter(leaves))


def _check_solves(entries, solves) -> None:
    names = [name for name, _, _ in entries]
    if names != [name for name, _ in solves]:
        raise RuntimeError(f"cond: the branch logged the solves {names}, declared "
                           f"{[name for name, _ in solves]}")


# the depths of conditional bodies a capture may nest (an IF body holding
# a WHILE node is two)
_DEPTHS = 2


def _conditional(step, kind: str, flag, run) -> None:
    """Capture `run()` as the body of a conditional node of `kind` ("while"
    or "if", `csrc/graph_cond.cu`) on the stream that captures now, its test
    the bool tensor `flag` (read before the node, and for "while" again at
    the body's end). The body is captured on the body stream of its depth,
    its tensors from the step's body pool of that depth. It may not launch
    a hand kernel: their launch counters assume that every recorded launch
    replays."""
    lib, dev = kernels.library(), flag.device
    depth = step.depth
    if depth >= _DEPTHS:
        raise RuntimeError(f"conditional bodies nested deeper than {_DEPTHS}")
    side, pool = _body_stream(dev, depth), step.body_pools[depth]
    begin = lib.graph_while_begin if kind == "while" else lib.graph_if_begin
    handle, graph = ctypes.c_ulonglong(0), ctypes.c_void_p(0)
    before = kernel_counts()
    kernels.check(begin(torch.cuda.current_stream(dev).cuda_stream, side.cuda_stream,
                        flag.data_ptr(), ctypes.byref(handle), ctypes.byref(graph)),
                  f"graph_{kind}_begin")
    step.depth += 1
    try:
        with torch.cuda.stream(side):
            torch._C._cuda_beginAllocateCurrentStreamToPool(dev.index, pool)
            try:
                run()
            finally:
                torch._C._cuda_endAllocateToPool(dev.index, pool)
    finally:
        step.depth -= 1
        err = (lib.graph_while_end(side.cuda_stream, handle, flag.data_ptr())
               if kind == "while" else lib.graph_if_end(side.cuda_stream))
    kernels.check(err, f"graph_{kind}_end")
    step.stats_of[kind] += 1
    step.stats_of[kind + "_body"] += _nodes(graph.value)
    if kernel_counts() != before:
        raise RuntimeError("a hand kernel launched inside a conditional body: its launch "
                           "counter would count replays that skip it")


_body_streams: dict = {}


def _body_stream(device: torch.device, depth: int) -> torch.cuda.Stream:
    """The stream that captures the conditional bodies of `depth` on
    `device`, made and warmed up once (a cuBLAS product, a Cholesky
    factorization and a triangular solve run on it eagerly, so that their
    handles and workspaces exist before a capture needs them)."""
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    side = _body_streams.get((device, depth))
    if side is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the conditional bodies' streams are made before a capture "
                               "(CapturedStep._capture)")
        side = _body_streams[device, depth] = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            a = torch.eye(4, device=device) + torch.ones(4, 4, device=device) @ torch.eye(
                4, device=device)
            chol, _ = torch.linalg.cholesky_ex(a)
            torch.linalg.solve_triangular(chol, a, upper=False)
        torch.cuda.synchronize(device)
    return side


@functools.lru_cache(maxsize=1)
def _libcuda():
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphGetNodes.restype = ctypes.c_int
    return lib


def _nodes(raw_graph: int) -> int:
    n = ctypes.c_size_t(0)
    err = _libcuda().cuGraphGetNodes(ctypes.c_void_p(raw_graph), None, ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed with CUresult {err}")
    return n.value


def pool_bytes(pool) -> int:
    """The bytes the caching allocator holds for a graph memory pool."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == tuple(pool))


def graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The top-level node count of a graph captured with `keep_graph=True`
    (a conditional node counts as one; its body's nodes are counted apart,
    `CapturedStep.stats`)."""
    return _nodes(graph.raw_cuda_graph())


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
    caller warms `fn` up before the first call (`warm_up`)."""

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
        # the graph's conditional nodes by kind and the nodes of their
        # bodies, the memory pools of the bodies' own tensors (one for each
        # depth of nesting), the depth the capture is at, and its LM solves'
        # (name, iteration count buffer, cap)
        self.stats_of = dict.fromkeys(("while", "while_body", "if", "if_body"), 0)
        self.body_pools: list = []
        self.depth = 0
        self.iterations: list = []

    def _capture(self):
        global _capturing
        before = kernel_counts()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.stats_of = dict.fromkeys(self.stats_of, 0)
        self.depth, self.iterations = 0, []
        while len(self.body_pools) < _DEPTHS:
            self.body_pools.append(torch.cuda.graph_pool_handle())
        for depth in range(_DEPTHS):
            _body_stream(self.device, depth)
        t0 = time.perf_counter()
        mode = torch.cuda.get_sync_debug_mode()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                # an operation that would wait for the device raises at once,
                # naming itself, instead of invalidating the capture
                torch.cuda.set_sync_debug_mode("error")
                _capturing = self
                try:
                    out = self.fn(*self.args)
                finally:
                    _capturing = None
                    torch.cuda.set_sync_debug_mode(mode)
        except Exception as exc:
            raise RuntimeError(f"CUDA graph capture of {self.name} failed at "
                               f"{_where(exc)}: {exc}") from exc
        finally:
            if collecting:
                gc.enable()
        t1 = time.perf_counter()
        graph.instantiate()
        t2 = time.perf_counter()
        self.graph, self.out = graph, out
        self.launches = {k: n - before.get(k, 0) for k, n in kernel_counts().items()
                         if n != before.get(k, 0)}
        for k, n in self.launches.items():
            recorded[k] = recorded.get(k, 0) + n
        # the pool's size after this capture (a runner's pool is shared by
        # its graphs)
        self.stats = {"capture_s": t1 - t0, "instantiate_s": t2 - t1,
                      "nodes": graph_nodes(graph), "while_nodes": self.stats_of["while"],
                      "while_body_nodes": self.stats_of["while_body"],
                      "if_nodes": self.stats_of["if"], "if_body_nodes": self.stats_of["if_body"],
                      "pool_bytes": pool_bytes(graph.pool())}

    def __call__(self):
        if self.device.type == "cuda":
            if self.graph is None:
                self._capture()
            self.graph.replay()
            for k, n in self.launches.items():
                replayed[k] = replayed.get(k, 0) + n
            if iteration_log is not None and self.iterations:
                # this replay's counts, before the next replay overwrites them
                counts = torch.stack([it for _, it, _ in self.iterations])
                iteration_log.extend((name, counts[i], cap)
                                     for i, (name, _, cap) in enumerate(self.iterations))
        else:
            out = self.fn(*self.args)
            if self.out is None:
                self.out = tree_map(torch.clone, out)
            else:
                tree_map(lambda d, s: d.copy_(s), self.out, out)
        self.replays += 1
        return self.out


def warm_up(fn, args, device) -> None:
    """Run `fn` once on clones of `args` on a side stream, so that nothing
    the capture needs is left uninitialised (the kernel library, cuBLAS
    and cuSOLVER handles, the cached launch tables) and no live buffer
    changes; its LM solves are not logged."""
    global iteration_log
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    log, iteration_log = iteration_log, None
    try:
        with torch.cuda.stream(side):
            fn(*tree_map(torch.clone, args))
    finally:
        iteration_log = log
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)


class _Eager:
    """The warm-up's executor: a runner's chain of steps run eagerly."""

    @staticmethod
    def captured(name, fn, args):
        return fn(*args)


class _Graphs:
    """What the OK-state runners share: the static state, the static
    inputs, the captured steps and their memory pool."""

    def __init__(self, state, consts, static, device):
        self.consts, self.static = consts, static
        self.device = torch.device(device)
        self.state = tree_map(torch.clone, state)
        self.pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        self.steps: dict[str, CapturedStep] = {}
        self._inputs: dict[str, torch.Tensor] = {}
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

    def _run(self, path: str, chain, *inputs):
        """Run `chain(executor, state, *inputs)` through the captured steps,
        after warming it up once (`warm_up`, on clones of the state and
        inputs, so that the warm-up does not advance the live state)."""
        if self.device.type == "cuda" and path not in self._warm_paths:
            warm_up(lambda st, *a: chain(_Eager, st, *a), (self.state, *inputs), self.device)
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

        def frame(st, img_l, img_r, gyr, acc, mask, u):
            return commit(st, *vio_mod.ok_step(st, img_l, img_r, gyr, acc, mask, None, c, s,
                                               ransac_u=u))

        return ex.captured("frame", frame, (state, *inputs))

    def ok_step(self, img_l, img_r, gyr, acc, mask, ransac_u) -> dict:
        """One fused OK frame (`models.vio.ok_step` with the uniforms
        given), one graph: the static metrics."""
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

        def ba(st, n_matches):
            new, cost, iters = vio_mod.stage_ba(st, n_matches, c, s)
            return commit(st, new, (cost, iters))

        def pool(st, cur, tr, cost, iters, dt, p_pred):
            new = vio_mod.stage_pool(st, cur, tr, tr.n_matches, c, s)
            return commit(st, new, vio_mod.frame_outputs(new, cur, tr, cost, iters, dt,
                                                         p_pred))

        dt, p_pred = ex.captured("imu", imu, (state, gyr, acc, mask))
        cur, tr = ex.captured("frontend", frontend, (state, img_l, img_r, u))
        cost, iters = ex.captured("ba", ba, (state, tr.n_matches))
        return ex.captured("pool", pool, (state, cur, tr, cost, iters, dt, p_pred))

    def staged_step(self, img_l, img_r, gyr, acc, mask, ransac_u) -> dict:
        """One OK frame as the four stages (`stage_imu`, `stage_frontend`,
        `stage_ba`, `stage_pool`), each its own graph: the static metrics
        (`models.vio.frame_outputs`)."""
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

    def _scan(self, ex, state, *inputs):
        c, s = self.consts, self.static

        def scan(st, imgs_l, imgs_r, gyrs, accs, masks, u):
            return commit(st, *vio_mod.ok_scan(st, imgs_l, imgs_r, gyrs, accs, masks, None, c, s,
                                               ransac_u=u))

        return ex.captured("scan", scan, (state, *inputs))

    def ok_scan(self, imgs_l, imgs_r, gyrs, accs, masks, generator) -> dict:
        """`models.vio.ok_scan` over T frames as one graph (the JAX
        package's one `lax.scan` dispatch), the T frames' uniforms drawn
        from `generator` first, in the order T `ok_step` calls draw them:
        the static stacked outputs (the newest R, p, v, n_tracked,
        is_keyframe, need_reinit). A new T captures a new graph."""
        u = torch.stack([torch.stack(vio_mod.draw_ransac_uniforms(generator, self.device))
                         for _ in range(imgs_l.shape[0])])
        return self._run("scan", self._scan, self._put("scan.img_l", imgs_l),
                         self._put("scan.img_r", imgs_r), self._put("scan.gyr", gyrs),
                         self._put("scan.acc", accs), self._put("scan.mask", masks),
                         self._put("scan.u", u))


class BatchedGraphs(_Graphs):
    """The batched step of `parallel.batched` (one extraction for the 2B
    images, `vmap` over the frame step, the clip of the B Schur
    complements between the two vmapped parts) for the batch size of its
    state, as one captured graph."""

    def __init__(self, state_b, consts, static, device):
        from pose_estimation_tpu_torch.parallel import batched

        super().__init__(state_b, consts, static, device)
        self._step = batched.make_batched_step(consts, static)

    def _batched(self, ex, state, *inputs):
        return ex.captured("batch", lambda st, *a: commit(st, *self._step(st, *a)),
                           (state, *inputs))

    def step(self, imgs_l, imgs_r, gyr, acc, mask, u_b) -> dict:
        """One batched frame (`parallel.batched.make_batched_step`'s step):
        the static metrics [B, ...]."""
        return self._run("batched", self._batched, self._put("imgs_l", imgs_l),
                         self._put("imgs_r", imgs_r), self._put("gyr", gyr),
                         self._put("acc", acc), self._put("mask", mask),
                         self._put("u", u_b))


class SolveGraphs:
    """The state machine's calls besides the OK-state steps: one graph for
    each name and each shape and type of the inputs' tensors, as JAX
    retraces per shape. The first call of a name and shapes runs eagerly:
    it is the warm-up, and a call made once a run (the left image's
    extraction, the initializer, the bootstrap frame, unless a reinit
    repeats them) pays neither a capture nor a pool. The second call
    captures the graph with a memory pool of its own; from then on `run`
    copies the inputs into the graph's static inputs and replays. The
    outputs of a replay are static (the next replay of the same graph
    overwrites them). The functions close over the configuration (`consts`,
    `static`): a new configuration takes a new runner."""

    def __init__(self, consts, static, device):
        self.consts, self.static = consts, static
        self.device = torch.device(device)
        self.steps: dict[tuple, CapturedStep] = {}
        self.calls: dict[tuple, int] = {}

    @staticmethod
    def key(name: str, args) -> tuple:
        """The graph's key: the name and the inputs' shapes and types."""
        return (name, *((tuple(t.shape), t.dtype) for t in tree_leaves(args)))

    def run(self, name: str, fn, *args):
        """`fn(*args)`: eagerly at the first call of the inputs' shapes,
        else as the captured step `name` of those shapes (its static
        outputs). `fn` is read at the first two calls of a shape."""
        key = self.key(name, args)
        n = self.calls[key] = self.calls.get(key, 0) + 1
        if n == 1:
            return fn(*args)
        step = self.steps.get(key)
        if step is None:
            static = tree_map(lambda t: t.to(self.device, copy=True), args)
            pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
            step = self.steps[key] = CapturedStep(name, fn, static, self.device, pool)
        else:
            for d, s in zip(tree_leaves(step.args), tree_leaves(args)):
                d.copy_(s)
        return step()

    def stats(self) -> dict:
        """Each call's eager runs and each graph's replays, launches,
        capture and instantiate seconds, node count and pool bytes, by name
        and chain or input length (the first dimension of its first input)
        where one name has several shapes."""
        out = {}
        for key, n in self.calls.items():
            name, *shapes = key
            many = sum(k[0] == name for k in self.calls) > 1
            label = f"{name}[{shapes[0][0][0]}]" if many and shapes and shapes[0][0] else name
            s = self.steps.get(key)
            out[label] = {"eager": 1, "replays": s.replays if s else 0,
                          "launches": s.launches if s else {}, **(s.stats if s else {})}
        return out
