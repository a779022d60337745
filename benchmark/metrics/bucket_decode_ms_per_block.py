"""Bucket decode: ms a block inside ``RxEngine._decode_bucket`` (one
``_payload_core`` per canonical config), synchronized, inclusive."""
SPANS = ("gr_ieee80211_tpu_torch.models.rx:RxEngine._decode_bucket",)


def read(t):
    return t.per_item_ms("RxEngine._decode_bucket")
