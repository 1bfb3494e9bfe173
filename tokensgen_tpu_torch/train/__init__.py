"""To2V adapter training (port of `tokensgen_tpu/train/`)."""
