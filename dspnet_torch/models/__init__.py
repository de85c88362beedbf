"""models (dspnet_torch)."""
