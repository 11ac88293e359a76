"""Kernel K1 (`csrc/fast_select.cu`) against its roofline: its least time
at the cell's shapes (`arith.k1_counts`: the plane stack of the step's
images, two a sequence) over its mean device time a launch in the traced
stretch, in %. Only where the image width is a multiple of 16 (else K3
detects)."""

from vio_bench import arith


def read(run):
    c, t = run.cfg, run.record.trace
    if t is None or c.image_width % arith.CELL:
        return None
    ms = t.mean_kernel_ms("fast_select_kernel")
    if ms is None:
        return None
    images = 2 * int(run.traffic.get("lanes", 1))
    n_bytes, n_instr = arith.k1_counts(images, c.image_height, c.image_width, c.level_pyramid,
                                       c.scale_factor)
    return 100.0 * arith.bound_ms(n_bytes, n_instr)[0] / ms
