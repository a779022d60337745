"""Bucket decode: ``RxEngine._decode_bucket`` calls a block (one a
canonical config and batch chunk)."""
SPANS = ("gr_ieee80211_tpu_torch.models.rx:RxEngine._decode_bucket",)


def read(t):
    return t.per_item_calls("RxEngine._decode_bucket")
