"""Launchers of the LM substrate (port of ``repro/launch``: ``serve``)."""
