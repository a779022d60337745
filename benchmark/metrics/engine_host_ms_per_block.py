"""Engine host: ms a block in ``RxEngine._finish`` outside its
``_decode_bucket`` calls (readback, classification, bucketing, NDP
estimates, result assembly), synchronized."""
SPANS = ("gr_ieee80211_tpu_torch.models.rx:RxEngine._finish",
         "gr_ieee80211_tpu_torch.models.rx:RxEngine._decode_bucket")


def read(t):
    total = t.per_item_ms("RxEngine._finish")
    if total is None:
        return None
    return total - t.per_item_ms("RxEngine._decode_bucket",
                                 parent="RxEngine._finish", default=0.0)
