"""CogVideoX MoT transformer, its config and the 3D-causal VAE."""
