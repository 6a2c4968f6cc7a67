"""Data: the synthetic LM token stream and the resumable batch pipeline."""
