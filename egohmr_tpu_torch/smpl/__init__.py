"""SMPL constants, linear blend skinning and the synthetic test model."""
from .loader import make_synthetic_model
from .model import (
    SMPLModel,
    SMPLOutput,
    lbs,
    lbs_apply_select,
    lbs_transforms,
    vertex_normals,
)

__all__ = ["SMPLModel", "SMPLOutput", "lbs", "lbs_apply_select",
           "lbs_transforms", "make_synthetic_model", "vertex_normals"]
