"""The benchmark of gr_ieee80211_tpu_torch (see BENCHMARK.json and run.py)."""
