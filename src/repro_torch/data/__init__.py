"""Synthetic data for the port (`repro_torch.data.synthetic`)."""
