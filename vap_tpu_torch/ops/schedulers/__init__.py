from .ddim import CogVideoXDDIMScheduler
from .flow_match import FlowMatchEulerScheduler
