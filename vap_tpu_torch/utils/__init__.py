"""Checkpoint files and directories: the safetensors format and the hub cache."""
