"""Model definitions of the port (nn.Modules named after diffusers' state-dict keys)."""
