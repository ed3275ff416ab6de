from .decoder import MotionDecoder
from .diffusion import AtomDiffusion

__all__ = ["MotionDecoder", "AtomDiffusion"]
