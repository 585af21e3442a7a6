"""Checkpointing (port of ``repro/checkpoint``)."""
from repro_torch.checkpoint.store import (latest_step, load,  # noqa: F401
                                          load_latest, save)
