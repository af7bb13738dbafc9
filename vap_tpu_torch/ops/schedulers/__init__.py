from .ddim import CogVideoXDDIMScheduler
from .dpm import CogVideoXDPMScheduler
from .flow_match import FlowMatchEulerScheduler
from .unipc import UniPCScheduler
