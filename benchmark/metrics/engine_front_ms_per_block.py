"""Engine front end + SIG: ms a block inside ``models/rx._front_core``
(detect, dedup, sync, SIG decode), synchronized, inclusive."""
SPANS = ("gr_ieee80211_tpu_torch.models.rx:_front_core",)


def read(t):
    return t.per_item_ms("_front_core")
