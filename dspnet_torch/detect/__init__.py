"""detect (dspnet_torch)."""
