"""HunyuanVideo text-to-video: the transformer, its config and the causal VAE's decoder."""
