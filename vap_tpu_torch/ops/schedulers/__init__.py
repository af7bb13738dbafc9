from .ddim import CogVideoXDDIMScheduler
