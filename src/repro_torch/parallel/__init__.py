"""Sharding rules and the active-rules context (PyTorch port of
``repro.parallel``), on ``torch.distributed``'s ``DeviceMesh`` and
``DTensor``."""
