"""The plain reference: frozen numpy copies of the parts of
gr_ieee80211_tpu_torch's gold model that the benchmark uses: the
transmitter that makes the traffic (``gold/{bits,sig,mac,tx}.py``,
``spec/{tables,params}.py``) and the receiver's front end and NDP channel
estimate (``gold/rx.py``), with their imports made local.  They are copies
so that the yardstick does not move when the program's own modules change;
nothing here imports the program, torch or JAX."""
