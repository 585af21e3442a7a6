"""Serving steps of the LM substrate (port of ``repro/train``; the
training half waits for ``ROADMAP.md`` queue 1 item 5)."""
