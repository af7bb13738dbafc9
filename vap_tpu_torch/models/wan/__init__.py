"""Wan2.1 MoT transformer, its config and the 3D-causal Wan VAE."""
