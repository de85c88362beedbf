"""utils (dspnet_torch)."""
