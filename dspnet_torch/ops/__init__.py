"""ops (dspnet_torch)."""
