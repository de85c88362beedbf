"""data (dspnet_torch)."""
