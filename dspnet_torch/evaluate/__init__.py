"""evaluate (dspnet_torch)."""
