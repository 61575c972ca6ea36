"""Engine and the JAX carry-over of the port."""
from .engine import DEFAULTS, ChannelSpec, Engine, GroupSpec
from .carry import params_from_jax, state_from_jax

__all__ = ["DEFAULTS", "ChannelSpec", "GroupSpec", "Engine", "params_from_jax",
           "state_from_jax"]
