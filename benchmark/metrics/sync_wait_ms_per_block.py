"""Engine, all stages: ms a block the host sits blocked at the program's
synchronizations: the summed host duration of the ``span:sync.*``
ranges (``utils/trace.sync``) in the profiled stretch's trace, over the
``entry:block`` ranges there.  The profiled stretch is read because no
synchronization but the program's own happens in it."""
from benchmark import program_trace  # noqa: F401  (turns the spans on)

SPANS = ()


def read(t):
    ranges = getattr(t.device, "_ranges", None) if t.device else None
    if not ranges:
        return None
    blocks = sum(1 for r in ranges if r[2] == "entry:block")
    waits = [e - s for s, e, name, _ in ranges
             if name.startswith("span:sync.")]
    if not blocks or not waits:
        return None
    return 1e-3 * sum(waits) / blocks
