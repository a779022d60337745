"""ZF equalize: ms a block the host spends in the two-stream zero-forcing
solve (``ops.ofdm.zf_equalize``): the summed host duration of the
program's ``span:rx.payload.zf`` ranges in the profiled stretch's trace,
over the ``entry:block`` ranges there (read as ``sync_wait_ms_per_block``
reads ``span:sync.*``); nothing where the program records no such span."""
from benchmark import program_trace  # noqa: F401  (turns the spans on)

SPANS = ()


def read(t):
    ranges = getattr(t.device, "_ranges", None) if t.device else None
    if not ranges:
        return None
    blocks = sum(1 for r in ranges if r[2] == "entry:block")
    zf = [e - s for s, e, name, _ in ranges if name == "span:rx.payload.zf"]
    if not blocks or not zf:
        return None
    return 1e-3 * sum(zf) / blocks
