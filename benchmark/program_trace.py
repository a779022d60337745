"""The program's own counters and spans (``gr_ieee80211_tpu_torch/utils/
trace.py``), for the per-layer readers that read them.

The first import of this module turns the program's spans on and takes
the counters' baseline.  ``run.traced`` imports every per-layer reader
of a cell before its profiled stretch, so the spans are on through both
traced stretches and in no untraced run.  A program without the tracing
module gives every reader nothing (``trace`` is None)."""
try:
    from gr_ieee80211_tpu_torch.utils import trace
except ImportError:
    trace = None

BASE: dict = {}
if trace is not None:
    trace.enable()
    BASE = trace.snapshot()


def ratio(num: str, den: str, t, scale: float = 1.0):
    """``scale`` x the change of counter ``num`` over the change of
    counter ``den`` since the baseline; None without a profiled stretch
    (``t.device``), without the tracing module, or where ``den`` did not
    move."""
    if trace is None or getattr(t, "device", None) is None:
        return None
    now = trace.snapshot()
    d = now.get(den, 0) - BASE.get(den, 0)
    if not d:
        return None
    return scale * (now.get(num, 0) - BASE.get(num, 0)) / d
