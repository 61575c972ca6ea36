"""Configuration: the radiod.conf loader and the preset table, building the
port's GroupSpec, ChannelSpec and SigGenConfig.

Same layered precedence as the reference (radio.c:713-727):
compiled defaults < [global] < preset < channel section.
"""
from .presets import PRESETS, preset_table
from .loader import load_config, RadiodConfig, parse_bool

__all__ = ["PRESETS", "preset_table", "load_config", "RadiodConfig", "parse_bool"]
