"""Clarity-first numpy golden model: bit pipeline, SIG fields, MAC framing, TX waveform, channel."""
