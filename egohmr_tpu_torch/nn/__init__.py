"""Modules and forward functions of the stage-2 model. The K1 kernel
wrapper (`pointnet_fused`) builds its CUDA library only when first called."""
from .core import batchnorm, batchnorm_eval, bf16_tensors, cast_params_bf16, linear, mm, silu
from .embedders import (
    FCHeadBeta,
    InputProcess,
    TimestepEmbedder,
    TranslEnc,
    fc_head_beta,
    input_process,
    timestep_embed,
    transl_enc,
)
from .gcn import ModulatedGCN, NonLocalBlock, modulated_gcn_forward, nonlocal_block
from .pointnet import ResnetPointnet, pointnet_forward
from .pointnet_fused import (
    pointnet_forward_fused,
    pointnet_fused_feature,
    pointnet_fused_reference,
)
from .resnet import ResNet, resnet_forward
