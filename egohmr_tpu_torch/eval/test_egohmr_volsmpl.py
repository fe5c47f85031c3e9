"""Stage-2 evaluation CLI, VolumetricSMPL-guided variant (port of
egohmr_tpu/eval/test_egohmr_volsmpl.py).

`test_egohmr` with other flag defaults: the learned signed-distance
collision backend (`--collision_backend volsdf`), the reference's
`--cond_grad_weight 30`, and the shipped distilled artifact
`artifacts/volsdf_synthetic.npz` as `--sdfnet_ckpt` where the checkout has
it (a VolumetricSMPL release `.ckpt` also loads, through
`interop.volsmpl_convert`). Every flag of `test_egohmr` is accepted and
still overrides these defaults.

Usage:
  python -m egohmr_tpu_torch.eval.test_egohmr_volsmpl --synthetic --num_samples 5
"""
from __future__ import annotations

import os

from .test_egohmr import main as _main
from .test_egohmr import parse_args as _parse_args

_SHIPPED_SDFNET = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "artifacts", "volsdf_synthetic.npz")


def _variant_defaults():
    d = dict(collision_backend="volsdf", cond_grad_weight=30.0)
    if os.path.exists(_SHIPPED_SDFNET):
        d["sdfnet_ckpt"] = _SHIPPED_SDFNET
    return d


def parse_args(argv=None):
    return _parse_args(argv, **_variant_defaults())


def main(argv=None):
    return _main(argv, **_variant_defaults())


if __name__ == "__main__":
    main()
