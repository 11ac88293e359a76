"""Kernel K3 (`csrc/fast_score_nms.cu`) against its roofline: its least
time at the cell's shapes (`arith.k3_counts`: the zero-padded plane stack
of the step's images, two a sequence) over its mean device time a launch
in the traced stretch, in %. Only where the image width is not a
multiple of 16 (else K1 detects)."""

from vio_bench import arith


def read(run):
    c, t = run.cfg, run.record.trace
    if t is None or c.image_width % arith.CELL == 0:
        return None
    ms = t.mean_kernel_ms("fast_score_nms_kernel")
    if ms is None:
        return None
    images = 2 * int(run.traffic.get("lanes", 1))
    n_bytes, n_instr = arith.k3_counts(images, c.image_height, c.image_width, c.level_pyramid)
    return 100.0 * arith.bound_ms(n_bytes, n_instr)[0] / ms
