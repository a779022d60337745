"""PyTorch + CUDA port of the IEEE 802.11a/n/ac PHY receive chain.

Each module mirrors its counterpart in ``gr_ieee80211_tpu`` (the JAX
reference) and keeps its public layouts, so the two can be held against
each other on the same inputs.  The package imports ``torch`` and never
``jax`` and nothing of the JAX package: it is self-contained, with its own
numpy layers (``spec``, ``gold``, ``runtime``).  ``spec.params.from_reference``
builds the port's config from any object with the same fields.
"""
