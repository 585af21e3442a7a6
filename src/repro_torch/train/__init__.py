"""Training and serving steps of the LM substrate (port of
``repro/train``: ``optimizer``, ``train_step``, ``serve_step``)."""
