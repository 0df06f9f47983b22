"""LM model zoo (counterpart of ``repro.models``): the dense / MoE / SSM /
hybrid / enc-dec / VLM backbones, each exposing the Model protocol
(api.py), so the launchers are family-agnostic."""
from .api import Model, build_model

__all__ = ["Model", "build_model"]
