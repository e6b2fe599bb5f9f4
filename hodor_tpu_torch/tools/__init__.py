"""Measurement tools of the port, run as `python -m hodor_tpu_torch.tools.<name>`."""
