"""Sample-file I/O (GNU Radio cf32 and openwifi text formats)."""
