"""Multi-process sharding over torch.distributed (``mesh``)."""
