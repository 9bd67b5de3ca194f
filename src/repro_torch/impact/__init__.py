"""The IMPACT crossbar system: Y-Flash device twin, tiles, the programmed
system, the energy model and the compiled-session runtime."""
from .energy import EnergyReport
from .pipeline import IMPACTConfig, IMPACTSystem, build_system
from .runtime import InferenceResult, InferenceSession, RuntimeSpec
from .tiles import (ClassTile, ClauseTile, encode_class_tile,
                    encode_clause_tile, weight_targets)
from .yflash import (DeviceVariation, G_HCS_BOOL, G_LCS, I_CSA_THRESHOLD,
                     erase_pulse, program_pulse, pulse_until, read_current)

__all__ = [
    "EnergyReport", "IMPACTConfig", "IMPACTSystem", "build_system",
    "InferenceResult", "InferenceSession", "RuntimeSpec",
    "ClassTile", "ClauseTile", "encode_class_tile", "encode_clause_tile",
    "weight_targets", "DeviceVariation", "G_HCS_BOOL", "G_LCS",
    "I_CSA_THRESHOLD", "erase_pulse", "program_pulse", "pulse_until",
    "read_current",
]
