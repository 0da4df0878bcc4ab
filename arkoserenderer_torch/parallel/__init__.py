"""Multi-device rendering: pixel-band sharding over torch.distributed."""
