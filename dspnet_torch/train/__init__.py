"""train (dspnet_torch)."""
