"""SMPL constants, linear blend skinning, the loader of the SMPL body files
and the synthetic test model."""
from . import constants
from .loader import (
    create,
    load_smpl_pkl,
    make_synthetic_model,
    make_synthetic_watertight_model,
)
from .model import (
    SMPLModel,
    SMPLOutput,
    lbs,
    lbs_apply_select,
    lbs_transforms,
    vertex_normals,
)

__all__ = ["constants", "SMPLModel", "SMPLOutput", "create", "lbs",
           "lbs_apply_select", "lbs_transforms", "load_smpl_pkl",
           "make_synthetic_model", "make_synthetic_watertight_model",
           "vertex_normals"]
