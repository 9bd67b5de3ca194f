"""The IMPACT crossbar system: Y-Flash device twin, tiles, the programmed
system, the energy model, the compiled-session runtime and its calibrated
cost model."""
from .costmodel import CostEstimate, SweepCostModel
from .energy import EnergyReport
from .pipeline import IMPACTConfig, IMPACTSystem, build_system
from .runtime import (CoResidentPlan, InferenceResult, InferenceSession,
                      RuntimeSpec, TenantSpan, build_coresident)
from .tiles import (ClassTile, ClauseTile, encode_class_tile,
                    encode_clause_tile, weight_targets)
from .yflash import (DeviceVariation, G_HCS_BOOL, G_LCS, I_CSA_THRESHOLD,
                     erase_pulse, program_pulse, pulse_until, read_current,
                     tune_adaptive)

__all__ = [
    "CostEstimate", "SweepCostModel", "EnergyReport", "IMPACTConfig", "IMPACTSystem", "build_system",
    "InferenceResult", "InferenceSession", "RuntimeSpec", "TenantSpan",
    "CoResidentPlan", "build_coresident",
    "ClassTile", "ClauseTile", "encode_class_tile", "encode_clause_tile",
    "weight_targets", "DeviceVariation", "G_HCS_BOOL", "G_LCS",
    "I_CSA_THRESHOLD", "erase_pulse", "program_pulse", "pulse_until",
    "read_current", "tune_adaptive",
]
