"""Training of the port: the CogVideoX VAP SFT step, its optimizer, checkpoints and trainer loop."""
