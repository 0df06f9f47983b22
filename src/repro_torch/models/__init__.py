"""LM model zoo (counterpart of ``repro.models``): the dense, MoE and VLM
backbones on one decoder skeleton, each exposing the Model protocol
(api.py), so the launchers are family-agnostic."""
from .api import Model, build_model

__all__ = ["Model", "build_model"]
