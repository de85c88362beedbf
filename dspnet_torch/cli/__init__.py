"""cli (dspnet_torch)."""
