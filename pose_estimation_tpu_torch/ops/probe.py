"""Stream probe: kernel K5, its twin and its sweep.

Counterpart of `benchmarks/launch_overhead_exp.py` of the JAX package, a
probe of what a kernel launch costs when every program streams one whole
plane of a stack and keeps one small tile of it: program g reads plane
`pp[g]` of a [n_planes, h, w] float32 or bfloat16 stack and writes
`2 * stack[pp[g], :8, :128]` in float32 to rows 8 g .. 8 g + 7 of the
output. Sweeping the plane count, the plane height and the element type
separates the fixed cost of a launch, the cost per block and the bytes
over the memory rate (`sweep`).

`stream_probe` launches `csrc/stream_probe.cu` on a CUDA tensor and runs
the twin `stream_probe_plain` only on a CPU tensor.
"""

from __future__ import annotations

import torch

from pose_estimation_tpu_torch.ops import kernels

TILE_ROWS, TILE_COLS = 8, 128
WIDTH = 768
# (planes, height, element type) of the sweep: the plane count at a fixed
# plane size, the plane height at a fixed count, the element type
SWEEP = (
    (64, 480, torch.float32), (128, 480, torch.float32), (256, 480, torch.float32),
    (512, 480, torch.float32),
    (256, 120, torch.float32), (256, 240, torch.float32), (256, 480, torch.float32),
    (256, 480, torch.float32), (256, 480, torch.bfloat16),
)
PROGS_PER_PLANE = 2
SWEEP_REPS = 6


def stream_probe_plain(stack: torch.Tensor, pp: torch.Tensor) -> torch.Tensor:
    """Twin of kernel K5: [8 * n_progs, 128] float32."""
    tiles = 2.0 * stack[pp.to(torch.int64), :TILE_ROWS, :TILE_COLS].to(torch.float32)
    return tiles.reshape(-1, TILE_COLS)


def stream_probe(stack: torch.Tensor, pp: torch.Tensor) -> torch.Tensor:
    """Kernel K5: one block per program reads its whole plane and writes
    twice the plane's top-left 8 x 128 tile.

    Replaces the TPU kernel `benchmarks/launch_overhead_exp.py:null_kernel`.
    On the H100 it is bound by the planes' bytes over the memory rate; each
    block pulls its plane through registers in 16-byte words and folds them
    into a checksum that is stored only under a launch argument this
    wrapper never sets, so the loads stay. The output is exact. A CUDA
    tensor launches the kernel (or raises); a CPU tensor runs
    `stream_probe_plain`."""
    if not stack.is_cuda:
        return stream_probe_plain(stack, pp)
    if stack.dtype not in (torch.float32, torch.bfloat16) or stack.ndim != 3 \
            or not stack.is_contiguous():
        raise ValueError("stream_probe needs a contiguous float32 or bfloat16 [N, H, W] stack")
    n, h, w = stack.shape
    if h < TILE_ROWS or w < TILE_COLS or (h * w * stack.element_size()) % 16:
        raise ValueError(f"stream_probe: bad plane shape {(h, w)}")
    if pp.dtype != torch.int32 or pp.ndim != 1 or not pp.is_contiguous() \
            or pp.device != stack.device:
        raise ValueError(f"stream_probe: pp must be contiguous int32 [n_progs] on {stack.device}")
    n_progs = pp.shape[0]
    out = torch.empty((TILE_ROWS * n_progs, TILE_COLS), dtype=torch.float32,
                      device=stack.device)
    if n_progs == 0:
        return out
    err = kernels.library().stream_probe_launch(
        stack.data_ptr(), pp.data_ptr(), out.data_ptr(), None, n_progs, h, w,
        stack.element_size(), 0, torch.cuda.current_stream(stack.device).cuda_stream,
    )
    kernels.check(err, "stream_probe")
    stream_probe.launches += 1
    return out


stream_probe.launches = 0


def sweep(device) -> list[dict]:
    """The probe's sweep on a CUDA device: for each entry of `SWEEP` a
    seeded uniform [0, 255) stack, two programs per plane, the mean device
    time of `SWEEP_REPS` launches after one warm-up (CUDA events), and from
    it the microseconds per block and the distinct planes' bytes per
    second. Each entry's output is held exactly equal to the twin's."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the sweep times the kernel on a CUDA device")
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for planes, h, dtype in SWEEP:
        stack = (torch.rand((planes, h, WIDTH), generator=gen, device=device) * 255).to(dtype)
        pp = torch.arange(planes, dtype=torch.int32, device=device).repeat_interleave(
            PROGS_PER_PLANE)
        out = stream_probe(stack, pp)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(SWEEP_REPS):
            out = stream_probe(stack, pp)
        end.record()
        torch.cuda.synchronize(device)
        ms = start.elapsed_time(end) / SWEEP_REPS
        if not torch.equal(out, stream_probe_plain(stack, pp)):
            raise RuntimeError(f"stream_probe differs from its twin at {(planes, h, dtype)}")
        n_bytes = stack.numel() * stack.element_size()
        rows.append({"planes": planes, "h": h, "dtype": str(dtype).removeprefix("torch."),
                     "programs": pp.shape[0], "mbytes": n_bytes / 1e6, "ms": ms,
                     "us_per_block": ms * 1e3 / pp.shape[0], "gbytes_per_s": n_bytes / ms / 1e6})
        del stack
    return rows
