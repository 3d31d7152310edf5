"""Core library: the MSDF digit-serial merged multiply-add as torch
modules (the port of ``repro.core``)."""
from . import bitplane, cycle_model, early_term, energy_model, mma, plane_schedule, quant  # noqa: F401
from .mma import mma_dot, mma_linear  # noqa: F401
from .plane_schedule import PlaneSchedule  # noqa: F401
from .quant import QTensor, quantize_acts, quantize_weights  # noqa: F401
