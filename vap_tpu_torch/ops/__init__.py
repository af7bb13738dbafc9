"""Attention, RoPE and scheduler ops of the port."""
