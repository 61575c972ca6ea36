"""Runtime of the port: the engine, the JAX carry-over, the signal
generator, the host front ends and the daemon (Radiod, imported lazily: it
pulls in the network stack)."""
from .engine import DEFAULTS, ChannelSpec, Engine, GroupSpec, migrate_state
from .carry import params_from_jax, state_from_jax
from .source import SigGenConfig, siggen_block, siggen_init

__all__ = ["DEFAULTS", "ChannelSpec", "GroupSpec", "Engine", "migrate_state", "params_from_jax",
           "state_from_jax", "SigGenConfig", "siggen_init", "siggen_block", "Radiod"]


def __getattr__(name):
    if name == "Radiod":
        from .radiod import Radiod
        return Radiod
    raise AttributeError(name)
