"""Measurement scripts of the port, run on the card (``python -m
transformer_clip_eeg_tpu_torch.tools.<name>``)."""
