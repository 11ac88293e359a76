"""The share of the traced stretch in which the card ran nothing, in %,
counting as busy both the profiler's device intervals (as
`device_idle_share` does) and the stamped device spans captured inside a
conditional node's body (`Span.body`: the LM iterations of a WHILE node,
the branches of an IF node), whose kernels the profiler's timeline does
not hold."""

from vio_bench import arith, stamps


def read(run):
    t, p = run.record.trace, stamps.program_trace(run)
    stretch, work = getattr(t, "stretch_ns", None), getattr(t, "device_ns", None)
    if p is None or stretch is None or work is None:
        return None
    lo, hi = stretch
    bodies = [(max(s.start, lo), min(s.end, hi)) for s in p.spans
              if s.kind == "device" and s.body]
    busy = arith.union_length(list(work) + [(a, b) for a, b in bodies if b > a])
    return 100.0 * (1.0 - busy / (hi - lo))
