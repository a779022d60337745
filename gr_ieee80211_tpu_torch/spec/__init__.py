"""802.11a/n/ac rate parameters and standard tables (numpy only)."""
